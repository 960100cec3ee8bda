"""A model of the H100 tensor cores' TF32 sums, for the CPU tests of the
port's float32 kernels (K1 / K6: ``tests/test_torch_f32_block.py``; K3 /
K4: ``tests/test_torch_mvit_f32.py``). A model, not a measurement: each
k8 step's products of TF32 values exact, every term aligned to the largest
and cut toward zero a few bits past f32's 24, the sum cut toward zero to
f32; the kernels fold each 32-deep stage of such sums into an f32 sum that
rounds to nearest."""

import torch

from audio_visual_deepfake_detection_tpu_torch.ops.kernels import fused_block as tfb


def rz_f32(s):
    """f64 values cut toward zero to f32."""
    _, e = torch.frexp(s)
    q = torch.ldexp(torch.ones_like(s), e - 24)
    return torch.where(s == 0, s, torch.trunc(s / q) * q)


def tc_k8(acc, a, b, guard=3):
    """One m64nNk8 TF32 step into an f32 accumulator, as modelled here (a
    model of the tensor cores, not a measurement): the 8 products of TF32
    values exact, every term (acc too) aligned to the largest one and cut
    toward zero below ``guard`` bits past f32's 24, the sum cut toward zero
    to f32. acc (M, N) f64 holding f32 values; a (M, 8), b (N, 8) f64 TF32
    values."""
    terms = torch.cat([acc[..., None], a[:, None, :] * b[None, :, :]], -1)
    _, e = torch.frexp(terms.abs().amax(-1, keepdim=True))
    q = torch.ldexp(torch.ones_like(terms[..., :1]), e - 24 - guard)
    return rz_f32((torch.trunc(terms / q) * q).sum(-1))


def tc_matmul(a, w, stage):
    """a @ w.T as the f32 kernels' 3xTF32 products sum it, in the model of
    ``tc_k8``: per stage of ``stage`` contraction values (the whole of it
    where 0), hi.lo, then lo.hi, then hi.hi k8 steps into one tensor-core
    sum, which is added to the f32 accumulator rounding to nearest. Returns
    f64 holding f32 values."""
    (ah, al), (wh, wl) = ([p.double() for p in tfb.tf32_split(x)] for x in (a, w))
    k = a.shape[1]
    stage = stage or k
    acc = torch.zeros(a.shape[0], w.shape[0], dtype=torch.float64)
    for k0 in range(0, k, stage):
        part = torch.zeros_like(acc)
        for x, y in ((ah, wl), (al, wh), (ah, wh)):
            for s in range(k0, k0 + stage, 8):
                part = tc_k8(part, x[:, s:s + 8], y[:, s:s + 8])
        acc = (acc + part).float().double()
    return acc


def fma_matmul(a, w):
    """a @ w.T summed in f32 one product at a time, rounding to nearest
    (the register-tiled FMA loop of the kernels' first f32 designs)."""
    acc = torch.zeros(a.shape[0], w.shape[0], dtype=torch.float64)
    a64, w64 = a.double(), w.double()
    for i in range(a.shape[1]):
        acc = (acc + a64[:, i, None] * w64[None, :, i]).float().double()
    return acc
