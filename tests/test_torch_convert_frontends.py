"""PyTorch port, the released frontend checkpoints' loaders
(``tools/convert_frontends.py``) against the JAX package's on the CPU.

The released files are not in the repository, so each test writes a
synthetic checkpoint in the documented on-disk layout from the port's own
modules with seeded, non-trivial weights (``init_*(perturb=True)``: biases,
LN affines, BN statistics, rel-pos tables, class token, extra tokens all
away from their init): AlignVideo's Lightning ``state_dict`` /
``hyper_parameters`` with C3D or MViT-v2 under ``video_encoder.``, fairseq's
``{"model", "cfg"}`` and BYOL-A's nested, prefixed ``.pth``, with the
extras the released files carry. The same dict goes through the JAX
loader (``(model, params)``, ``model.apply``) and the port's (an
``nn.Module`` on the CPU), and the features agree at the port's encoder
tolerances: C3D and BYOL-A 1e-4, MViT-v2 2e-4, Emotion2Vec 2e-4 / 1e-3.
The wrappers' prefix and EMA handling equal the JAX functions'. The slice
as a whole: the three files saved with ``torch.save`` and read back with
``weights_only=True``, both packages' loaders, both ``FeatureExtractor``s,
``extract_to_cache`` on a cv2-written mp4 and its wav: the same caches."""

import argparse
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_visual_deepfake_detection_tpu.frontends import pipeline as jfront
from audio_visual_deepfake_detection_tpu.tools import convert_frontends as jcf
from audio_visual_deepfake_detection_tpu_torch.frontends import pipeline as tfront
from audio_visual_deepfake_detection_tpu_torch.frontends.byola import (
    AudioNTT2020, init_byola)
from audio_visual_deepfake_detection_tpu_torch.frontends.emotion2vec import (
    Emotion2Vec, Emotion2VecConfig, init_emotion2vec)
from audio_visual_deepfake_detection_tpu_torch.frontends.mvit import init_mvit, mvit_v2_t
from audio_visual_deepfake_detection_tpu_torch.frontends.video import C3DVideoEncoder, init_c3d
from audio_visual_deepfake_detection_tpu_torch.tools import convert_frontends as tcf

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_media import jax_native_media, smooth_frames, write_mp4  # noqa: E402

C3D_NF, C3D_OUT = (4, 6, 8, 8), 16
BYOLA_D = 16
E2V_SMALL = dict(embed_dim=64, num_heads=2, conv_pos_groups=2, depth=2, prenet_depth=1)
TOL = {"video": dict(atol=1e-4, rtol=0), "mvit": dict(atol=2e-4, rtol=0),
       "byola": dict(atol=1e-4, rtol=0), "emotion": dict(atol=2e-4, rtol=1e-3)}
CPU = dict(device="cpu")


def numpy_sd(module: torch.nn.Module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def c3d_encoder(seed=3):
    return init_c3d(C3DVideoEncoder(C3D_NF, C3D_OUT), seed, perturb=True)


def alignvideo_c3d(enc_sd, hparams=True, bare=False, ema=None):
    """A Lightning AlignVideo checkpoint around a C3D state dict: under
    DataParallel's ``module.``, with a foreign audio encoder and classifier,
    optionally an EMA twin; ``bare`` drops the ``.conv`` children."""
    def wrap(sd):
        sd = {(k.replace(".conv.", ".") if bare and not k.startswith("block3.5") else k): v
              for k, v in sd.items()}
        out = {f"module.video_encoder.{k}": v for k, v in sd.items()}
        out["module.audio_encoder.block0.conv.weight"] = np.ones((4, 1, 3), np.float32)
        out["module.frame_classifier.fc.weight"] = np.ones((1, 16), np.float32)
        return out

    ckpt = {"state_dict": wrap(enc_sd)}
    if ema is not None:
        ckpt["state_dict_ema"] = wrap(ema)
    hp = {"ve_features": list(C3D_NF), "v_cla_feature_in": C3D_OUT, "temporal_dim": 512}
    if hparams:
        hp["v_encoder"] = "c3d"
    ckpt["hyper_parameters"] = hp
    return ckpt


def jax_features(model, params, x, **kw):
    """The JAX loader's model on its params, jitted (flax op by op is
    several times slower on the CPU)."""
    return np.asarray(jax.jit(functools.partial(model.apply, **kw))(params, jnp.asarray(x)))


def as_tensors(tree):
    """numpy leaves as tensors: what ``torch.load(weights_only=True)`` reads."""
    if isinstance(tree, dict):
        return {k: as_tensors(v) for k, v in tree.items()}
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


def port_features(model, x, *args):
    with torch.no_grad():
        return model(torch.from_numpy(x), *args).numpy()


# ---------------------------------------------------------------- wrappers

WRAPPER_CASES = {
    "mixed": {"module.a.w": 1, "b.w": 2},
    "nested": {"module.model.a.w": 1, "module.model.b.w": 2},
    "model_only": {"model.w": 1},
    "compiled": {"_orig_mod.x": 3, "_orig_mod.y": 4},
    "ema_twin": {"state_dict": {"module.video_encoder.w": 0.0},
                 "state_dict_ema": {"module.video_encoder.w": 1.0},
                 "hyper_parameters": {"v_encoder": "c3d", "temporal_dim": 16}},
    "hparams_key": {"state_dict": {"model.video_encoder.w": 2.0},
                    "hparams": {"v_cla_feature_in": 8}},
    "raw": {"video_encoder.w": 2.0, "video_encoder.b": 3.0},
}


@pytest.mark.parametrize("name", sorted(WRAPPER_CASES))
def test_wrappers_equal_jax(name):
    ckpt = WRAPPER_CASES[name]
    assert tcf.strip_wrapper_prefixes(ckpt) == jcf.strip_wrapper_prefixes(ckpt)
    for use_ema in (False, True):
        assert tcf.unwrap_lightning(ckpt, use_ema) == jcf.unwrap_lightning(ckpt, use_ema)
    if name == "ema_twin":
        assert tcf.unwrap_lightning(ckpt, True)[0] == {"video_encoder.w": 1.0}


# ---------------------------------------------------------------- AlignVideo

@pytest.mark.parametrize("hparams", [True, False], ids=["v_encoder", "inferred"])
@pytest.mark.parametrize("bare", [False, True], ids=["conv_child", "bare"])
def test_alignvideo_c3d_matches_jax(hparams, bare):
    """C3D at (4, 6, 8, 8) -> 16: ``v_encoder`` given, or inferred from a
    layout without ``mvit.`` keys; keys with and without the ``.conv``
    child; the EMA twin picked by ``use_ema``; the foreign submodules
    ignored. 2 chunks of 16 frames, atol 1e-4."""
    enc, ema = c3d_encoder(3), c3d_encoder(4)
    ckpt = alignvideo_c3d(numpy_sd(enc), hparams, bare, ema=numpy_sd(ema))
    x = np.random.default_rng(0).uniform(0, 1, (2, 16, 96, 96, 3)).astype(np.float32)
    for use_ema, src in ((False, enc), (True, ema)):
        port = tcf.load_alignvideo_checkpoint(ckpt, use_ema=use_ema, **CPU)
        assert isinstance(port, C3DVideoEncoder) and not port.training
        assert all(torch.equal(a, b) for a, b in zip(port.state_dict().values(),
                                                     src.state_dict().values()))
        jm, jp = jcf.load_alignvideo_checkpoint(ckpt, use_ema=use_ema)
        got, want = port_features(port, x), jax_features(jm, jp, x)
        assert got.shape == (2, 16, C3D_OUT)
        np.testing.assert_allclose(got, want, **TOL["video"])
        assert np.abs(want).max() > 1e-2


def test_alignvideo_mvit_depth_count_matches_jax():
    """torchvision MViT-v2 names under ``model.video_encoder.mvit.`` with
    its classifier ``head.1`` and a foreign submodule, hparams without
    ``v_encoder``: the 10 block indices pick ``mvit_v2_t``, ``temporal_dim``
    16 sizes its rel-pos tables, ``v_cla_feature_in`` its output. 2 chunks
    of 16 frames, atol 2e-4."""
    enc = init_mvit(mvit_v2_t(out_dim=32, temporal_size=16), seed=5, perturb=True)
    sd = {f"model.video_encoder.mvit.{k}": v for k, v in numpy_sd(enc).items()}
    sd["model.video_encoder.mvit.head.1.weight"] = np.ones((400, 768), np.float32)
    sd["model.video_encoder.mvit.head.1.bias"] = np.ones(400, np.float32)
    sd["model.audio_encoder.proj.weight"] = np.ones((4, 4), np.float32)
    ckpt = {"state_dict": sd, "hyper_parameters": {"temporal_dim": 16, "v_cla_feature_in": 32}}
    port = tcf.load_alignvideo_checkpoint(ckpt, **CPU)
    assert len(port.blocks) == 10 and port.temporal_size == 16
    assert port.blocks[0].attn.rel_pos_t.shape == enc.blocks[0].attn.rel_pos_t.shape
    jm, jp = jcf.load_alignvideo_checkpoint(ckpt)
    x = np.random.default_rng(1).uniform(0, 1, (2, 16, 96, 96, 3)).astype(np.float32)
    got, want = port_features(port, x), jax_features(jm, jp, x)
    assert got.shape == (2, 16, 32)
    np.testing.assert_allclose(got, want, **TOL["mvit"])
    assert np.abs(want).max() > 1e-2


# ---------------------------------------------------------------- Emotion2Vec

def fairseq_cfg(cfg) -> dict:
    """An ``Emotion2VecConfig`` as the checkpoint's ``cfg`` node."""
    return {"model": {
        "embed_dim": cfg.embed_dim, "depth": cfg.depth, "num_heads": cfg.num_heads,
        "mlp_ratio": cfg.mlp_ratio, "norm_eps": cfg.norm_eps,
        "modalities": {"audio": {
            "prenet_depth": cfg.prenet_depth, "num_extra_tokens": cfg.num_extra_tokens,
            "use_alibi_encoder": cfg.use_alibi, "conv_pos_depth": cfg.conv_pos_depth,
            "conv_pos_width": cfg.conv_pos_width, "conv_pos_groups": cfg.conv_pos_groups}}}}


def fairseq_checkpoint(model: Emotion2Vec) -> dict:
    """fairseq's layout with the teacher and decoder extras."""
    sd = numpy_sd(model)
    sd["_ema.blocks.0.attn.qkv.weight"] = np.zeros((1,), np.float32)
    sd["decoder.proj.weight"] = np.zeros((1,), np.float32)
    sd["modality_encoders.AUDIO.decoder.blocks.0.weight"] = np.zeros((1,), np.float32)
    return {"model": sd, "cfg": fairseq_cfg(model.cfg)}


@pytest.mark.parametrize("extra", [{}, dict(num_extra_tokens=2, use_alibi=True)],
                         ids=["base", "extra_tokens_alibi"])
def test_emotion2vec_fairseq_matches_jax(extra):
    cfg = Emotion2VecConfig(**E2V_SMALL, **extra)
    model = init_emotion2vec(Emotion2Vec(cfg), seed=6, perturb=True)
    if cfg.use_alibi:
        with torch.no_grad():
            model.audio.alibi_scale.fill_(0.7)
    ckpt = fairseq_checkpoint(model)
    port = tcf.load_emotion2vec_checkpoint(ckpt, **CPU)
    assert port.cfg == cfg and not port.training
    jm, jp = jcf.load_emotion2vec_checkpoint(ckpt)
    assert dataclasses.asdict(jm.cfg) == dataclasses.asdict(cfg)
    wav = (np.random.default_rng(2).standard_normal((2, 16000)) * 0.1).astype(np.float32)
    got, want = port_features(port, wav), jax_features(jm, jp, wav)
    assert got.shape == (2, 49, cfg.embed_dim)
    np.testing.assert_allclose(got, want, **TOL["emotion"])


def test_emotion2vec_config_from_fairseq_equals_jax():
    """The round trip, the defaults for missing fields, ``cfg.model``
    given directly, and a Namespace node read by attribute."""
    cfg = Emotion2VecConfig(depth=3, prenet_depth=2, num_extra_tokens=10, use_alibi=True)
    node = fairseq_cfg(cfg)
    assert tcf.emotion2vec_config_from_fairseq(node) == cfg
    assert tcf.emotion2vec_config_from_fairseq(node["model"]) == cfg
    assert tcf.emotion2vec_config_from_fairseq({"model": {}}) == Emotion2VecConfig()
    assert tcf.emotion2vec_config_from_fairseq(None) == Emotion2VecConfig()
    ns = argparse.Namespace(model=argparse.Namespace(
        depth=4, embed_dim=None, modalities=argparse.Namespace(
            audio=argparse.Namespace(prenet_depth=1, use_alibi_encoder=True))))
    got = tcf.emotion2vec_config_from_fairseq(ns)
    assert got == Emotion2VecConfig(depth=4, prenet_depth=1, use_alibi=True)
    for node in (fairseq_cfg(cfg), {"model": {}}, None, ns):
        assert dataclasses.asdict(tcf.emotion2vec_config_from_fairseq(node)) == \
            dataclasses.asdict(jcf.emotion2vec_config_from_fairseq(node))


# ---------------------------------------------------------------- BYOL-A

def byola_checkpoint(model: AudioNTT2020, with_counts=True) -> dict:
    """The encoder under a BYOL wrapper's prefix, nested under
    ``state_dict``, with keys the reference's regex drops."""
    sd = {f"module.encoder.{k}": v for k, v in numpy_sd(model).items()
          if with_counts or "num_batches_tracked" not in k}
    sd["module.projector.0.weight"] = np.zeros((1,), np.float32)
    sd["module.target.momentum"] = np.zeros((1,), np.float32)
    return {"state_dict": sd}


@pytest.mark.parametrize("with_counts", [True, False], ids=["bn_counts", "no_bn_counts"])
def test_byola_pth_matches_jax(with_counts):
    """Nonzero BN statistics; a file with or without the batch norms'
    ``num_batches_tracked`` (the module keeps its own where the file has
    none). atol 1e-4."""
    model = init_byola(AudioNTT2020(d=BYOLA_D), seed=7, perturb=True)
    with torch.no_grad():
        for i in (1, 5, 9):
            model.features[i].num_batches_tracked.fill_(1000 + i)
    ckpt = byola_checkpoint(model, with_counts)
    port = tcf.load_byola_checkpoint(ckpt, d=BYOLA_D, **CPU)
    assert int(port.features[5].num_batches_tracked) == (1005 if with_counts else 0)
    assert float(port.features[1].running_mean.abs().max()) > 0
    jm, jp = jcf.load_byola_checkpoint(ckpt, d=BYOLA_D)
    lms = np.random.default_rng(3).standard_normal((2, 96, 64)).astype(np.float32)
    got, want = port_features(port, lms), jax_features(jm, jp, lms, train=False)
    assert got.shape == (2, 12, BYOLA_D)
    np.testing.assert_allclose(got, want, **TOL["byola"])


# ---------------------------------------------------------------- refusals

def test_foreign_missing_and_misshapen_raise():
    with pytest.raises(KeyError, match="video_encoder"):
        tcf.load_alignvideo_checkpoint({"state_dict": {"encoder.w": np.zeros(1, np.float32)}},
                                       **CPU)
    with pytest.raises(KeyError):
        jcf.load_alignvideo_checkpoint({"state_dict": {"encoder.w": np.zeros(1, np.float32)}})
    ckpt = alignvideo_c3d(numpy_sd(c3d_encoder()))
    del ckpt["state_dict"]["module.video_encoder.block1.1.conv.bias"]
    with pytest.raises(RuntimeError, match=r"Missing key.*block1\.1\.conv\.bias"):
        tcf.load_alignvideo_checkpoint(ckpt, **CPU)
    # no hyper_parameters: the production widths, which these tensors do not have
    ckpt = alignvideo_c3d(numpy_sd(c3d_encoder()))
    del ckpt["hyper_parameters"]
    with pytest.raises(RuntimeError, match=r"size mismatch for block0\.0\.conv\.weight"):
        tcf.load_alignvideo_checkpoint(ckpt, **CPU)
    e2v = fairseq_checkpoint(init_emotion2vec(Emotion2Vec(Emotion2VecConfig(**E2V_SMALL)), 1))
    del e2v["model"]["blocks.1.mlp.fc2.weight"]
    with pytest.raises(RuntimeError, match=r"blocks\.1\.mlp\.fc2\.weight"):
        tcf.load_emotion2vec_checkpoint(e2v, **CPU)


@pytest.mark.parametrize("loader", ["alignvideo", "emotion2vec", "byola"])
def test_loaders_default_to_the_card(loader):
    """``device`` left at its default is the card: here, without one, the
    loader raises instead of building on the CPU."""
    assert not torch.cuda.is_available()
    ckpt = {"alignvideo": lambda: alignvideo_c3d(numpy_sd(c3d_encoder())),
            "emotion2vec": lambda: fairseq_checkpoint(
                Emotion2Vec(Emotion2VecConfig(**E2V_SMALL))),
            "byola": lambda: byola_checkpoint(AudioNTT2020(d=BYOLA_D))}[loader]()
    fn = getattr(tcf, f"load_{loader}_checkpoint")
    kw = {"d": BYOLA_D} if loader == "byola" else {}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(ckpt, **kw)
    assert not fn(ckpt, **kw, device="cpu").training


# ---------------------------------------------------------------- the slice

def test_released_layout_files_to_caches_match_jax(tmp_path):
    """Three files in the released layouts (C3D AlignVideo with hparams,
    fairseq Emotion2Vec, nested BYOL-A) written with ``torch.save`` and read
    back with ``weights_only=True``; each package's loaders and
    ``FeatureExtractor``; ``extract_to_cache`` on a cv2-written 64x64 mp4 of
    21 frames and its 1.2 s wav: the same three caches."""
    from scipy.io import wavfile

    jax_native_media()
    rng = np.random.default_rng(9)
    files = {
        "alignvideo_model.ckpt": alignvideo_c3d(numpy_sd(c3d_encoder(11))),
        "emotion2vec_base.pt": fairseq_checkpoint(init_emotion2vec(
            Emotion2Vec(Emotion2VecConfig(**E2V_SMALL)), seed=12, perturb=True)),
        "byola.pth": byola_checkpoint(init_byola(AudioNTT2020(d=BYOLA_D), seed=13,
                                                 perturb=True)),
    }
    read = {}
    for name, blob in files.items():
        torch.save(as_tensors(blob), tmp_path / name)
        read[name] = torch.load(tmp_path / name, weights_only=True)
    video = tcf.load_alignvideo_checkpoint(read["alignvideo_model.ckpt"], **CPU)
    emotion = tcf.load_emotion2vec_checkpoint(read["emotion2vec_base.pt"], **CPU)
    byola = tcf.load_byola_checkpoint(read["byola.pth"], d=BYOLA_D, **CPU)
    tex = tfront.FeatureExtractor(video_model=video, byola_model=byola, emotion_model=emotion,
                                  video_chunk=16, device="cpu")
    jvm, jvp = jcf.load_alignvideo_checkpoint(read["alignvideo_model.ckpt"])
    jem, jep = jcf.load_emotion2vec_checkpoint(read["emotion2vec_base.pt"])
    jbm, jbp = jcf.load_byola_checkpoint(read["byola.pth"], d=BYOLA_D)
    jex = jfront.FeatureExtractor(
        params=jfront.FrontendParams(video=jvp, byola=jbp, emotion=jep),
        video_model=jvm, byola_model=jbm, emotion_model=jem, video_chunk=16)

    mp4, wav = str(tmp_path / "clip.mp4"), str(tmp_path / "clip.wav")
    write_mp4(mp4, smooth_frames(rng, 21, 64, 64))
    wavfile.write(wav, 16000, (rng.standard_normal(19200) * 3000).astype(np.int16))
    tex.extract_to_cache(mp4, wav, str(tmp_path / "port"), "clip.npy")
    jex.extract_to_cache(mp4, wav, str(tmp_path / "jax"), "clip.npy")
    rows = {"video": 21, "byola": (1 + 19200 // 160) // 8, "emotion": 59}
    for key, name in tfront.CACHE_DIR_NAMES.items():
        got = np.load(tmp_path / "port" / name / "clip.npy")
        want = np.load(tmp_path / "jax" / name / "clip.npy")
        assert got.dtype == np.float32 and got.shape == want.shape and got.shape[0] == rows[key]
        np.testing.assert_allclose(got, want, **TOL[key], err_msg=key)
        assert np.abs(want).max() > 1e-2
