"""PyTorch / CUDA port of the audio-visual deepfake temporal localizer.

The JAX package ``audio_visual_deepfake_detection_tpu`` stays the reference;
this package computes the same functions in PyTorch for an NVIDIA Hopper
card (sm_90). It keeps the JAX package's layout and module names:

    core/          jax-free ArchConfig / TestConfig, device + kernel policy
    ops/           masked convs, norms, resamples, PE, batched soft-NMS
    ops/kernels/   hand-written CUDA kernels with their plain-torch versions
    models/        blocks, HRLR backbone, FPN, heads, points, AVLocalizer
    frontends/     MViT-v2 video encoder, chunking and resize, FeatureExtractor
    infer/         decode + postprocess, inference fn, LocalizerService
    tools/         weight conversion from the JAX package's flax trees
    csrc/          CUDA C++ sources, built with nvcc at first use

Public tensors keep JAX's ``(B, T, C)`` layout. Parameter names are the
original torch repo's state-dict names (torchvision's for MViT), so the JAX
package's ``tools/convert_torch.py`` and ``convert_mvit_torch`` map between
the two.

Importing the package never imports ``jax``.
"""

from .core.runtime import set_numerics

# f32 means f32: no TF32 in matmuls or cuDNN convolutions (the embed conv and
# the interpolator convs would otherwise lose ~3 decimal digits)
set_numerics()

__version__ = "0.1.0"
