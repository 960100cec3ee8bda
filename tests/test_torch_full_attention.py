"""PyTorch port: the plain version of kernel K8 (``full_mha_math``) vs the
JAX ``full_mha`` in the Pallas interpreter and vs the XLA einsum path of
``AltAttention``, on the CPU.

Tolerances are those of ``tests/test_full_attention.py``: f32 atol 2e-5,
bf16 atol 5e-2, rtol 0 (the kernel divides by the softmax denominator after
the value product, the XLA path and the plain version before it)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from audio_visual_deepfake_detection_tpu.ops.pallas import full_attention as jk8
from audio_visual_deepfake_detection_tpu_torch.ops.kernels import full_attention as tk8

TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _xla_mha(q, k, v, padding_mask=None):
    att = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32)
    if padding_mask is not None:
        att = jnp.where(padding_mask[:, None, None, :], -jnp.inf, att)
    att = jax.nn.softmax(att.astype(jnp.float32), axis=-1).astype(v.dtype)
    return jnp.einsum("bhqk,bhkd->bhqd", att, v)


def _case(t, d, dtype, masked, seed=0, b=2, h=3):
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3)]
    qkv[0] *= d ** -0.5
    mask = None
    if masked:
        lens = np.array([t, (2 * t) // 3])
        mask = np.arange(t)[None, :] >= lens[:, None]
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    jq = [jnp.asarray(a, jd) for a in qkv]
    tq = [torch.from_numpy(a).to(td) for a in qkv]
    return jq, tq, mask


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [128, 130, 499])
def test_math_matches_jax(t, dtype, masked):
    jq, tq, mask = _case(t, 64, dtype, masked, seed=t)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    got = tk8.full_mha_math(*tq, tmask)
    assert got.dtype == tq[0].dtype and tuple(got.shape) == (2, 3, t, 64)
    got = got.float().numpy()
    assert np.isfinite(got).all()                     # pad query rows included
    kernel = np.asarray(jk8.full_mha(*jq, jmask, interpret=True), np.float32)
    xla = np.asarray(jax.jit(_xla_mha)(*jq, jmask), np.float32)
    np.testing.assert_allclose(got, xla, atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(got, kernel, atol=TOL[dtype], rtol=0)


def _ragged_case(t, d, masked, seed, h=2):
    """One sample, f32; the mask pads its final third."""
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((1, h, t, d)).astype(np.float32) for _ in range(3)]
    qkv[0] *= d ** -0.5
    mask = (np.arange(t)[None, :] >= (2 * t) // 3) if masked else None
    return qkv, mask


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_math_matches_jax_shorter_than_a_key_tile(dtype, masked):
    """T = 50: fewer keys than the CUDA kernel's 64-key tile."""
    jq, tq, mask = _case(50, 64, dtype, masked, seed=50)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    got = tk8.full_mha_math(*tq, tmask).float().numpy()
    assert np.isfinite(got).all()
    kernel = np.asarray(jk8.full_mha(*jq, jmask, interpret=True), np.float32)
    xla = np.asarray(jax.jit(_xla_mha)(*jq, jmask), np.float32)
    np.testing.assert_allclose(got, xla, atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(got, kernel, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_math_matches_jax_long_sequence(masked):
    """T = 1700, past the ~1600 rows the first CUDA design could hold in shared
    memory; the JAX side on its XLA path (the interpreter at this T takes
    minutes). f32 atol 2e-5."""
    qkv, mask = _ragged_case(1700, 32, masked, seed=1700)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    got = tk8.full_mha_math(*(torch.from_numpy(a) for a in qkv), tmask).numpy()
    assert got.shape == (1, 2, 1700, 32) and np.isfinite(got).all()
    xla = np.asarray(jax.jit(_xla_mha)(*(jnp.asarray(a) for a in qkv), jmask))
    np.testing.assert_allclose(got, xla, atol=2e-5, rtol=0)


@pytest.mark.parametrize("t", [50, 1700])
def test_wrapper_on_cpu_takes_any_length(t):
    """No cap on T in the wrapper: a CPU tensor of any length takes the
    plain version through strided (b, t, 3, h, d) views, and counts no launch."""
    qkv, mask = _ragged_case(t, 32, True, seed=t)
    packed = torch.from_numpy(np.stack(qkv, 0)).permute(1, 3, 0, 2, 4).contiguous()
    q, k, v = packed.permute(2, 0, 3, 1, 4)
    tmask = torch.from_numpy(mask)
    tk8.reset_launches()
    got = tk8.full_mha(q, k, v, tmask)
    want = tk8.full_mha_math(*(torch.from_numpy(a) for a in qkv), tmask)
    assert tuple(got.shape) == (1, 2, t, 32) and tk8.LAUNCHES == 0
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_head_dim_32_and_wrapper_on_cpu():
    """d = 32 (the small configs' head dim); a CPU tensor takes the plain
    version, strided q/k/v views included, and counts no launch."""
    jq, tq, mask = _case(70, 32, "float32", True, seed=5)
    want = np.asarray(jk8.full_mha(*jq, jnp.asarray(mask), interpret=True))
    qkv = torch.stack(tq, 0).permute(1, 3, 0, 2, 4).contiguous()       # (b, t, 3, h, d)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    tk8.reset_launches()
    got = tk8.full_mha(q, k, v, torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    assert tk8.LAUNCHES == 0


def test_wrapper_refuses_bad_inputs():
    q = torch.zeros((1, 2, 8, 32))
    with pytest.raises(ValueError):
        tk8.full_mha(q, q[:, :1], q)
    with pytest.raises(ValueError):
        tk8.full_mha(q, q, q, torch.zeros((1, 9), dtype=torch.bool))
    with pytest.raises(ValueError):
        tk8.full_mha(q.double(), q.double(), q.double())


def test_k8_bf16_check_holds_the_kernel_to_the_f32_function():
    """chip_smoke.py's bf16 K8 check states its per-element bound against the
    f32 function of the same bf16 inputs alone: an output inside the
    kernel's own rounding budget 2^-8 (sum_j p_j |v_j| + 2 |out|) passes
    wherever the plain version's rounding lands (here at the far edge of its
    own budget, on the other side), and one past it fails."""
    import chip_smoke

    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 8, 64)).astype(np.float32))
               for _ in range(3))
    q, k, v = (q * 64 ** -0.5).bfloat16(), k.bfloat16(), v.bfloat16()
    exact = tk8.full_mha_math(q.float(), k.float(), v.float(), None)
    spread = tk8.full_mha_math(q.float(), k.float(), v.float().abs(), None)
    u = 2.0 ** -8
    ref = exact + 0.9 * u * (spread + exact.abs())
    inside = (exact - 0.45 * u * (spread + 2 * exact.abs())).bfloat16()
    _, ok, rule = chip_smoke.check_k8(inside, ref, q, k, v, None)
    assert ok, rule
    past = (exact + 1.5 * u * (spread + 2 * exact.abs())).bfloat16()
    assert not chip_smoke.check_k8(past, ref, q, k, v, None)[1]
