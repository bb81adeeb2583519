"""Numerical parity of the converted CLIP vision tower vs torch.

Real CLIP weights cannot be fetched in this environment, but the
architecture can be validated exactly: instantiate HF's torch
``CLIPVisionModelWithProjection`` with random weights, convert it with
models/convert_clip.py, and assert the jitted JAX tower (models/embed.py)
produces the same normalized image embeddings as torch on the same pixels.
Covers both CLIP activation variants ("quick_gelu" = OpenAI checkpoints,
"gelu" = most others) and the pre-layernorm path. A converted *trained*
checkpoint therefore reranks identically to its torch original.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hydrus_video_deduplicator_tpu.models import embed  # noqa: E402
from hydrus_video_deduplicator_tpu.models.convert_clip import (  # noqa: E402
    convert_vision_model,
)


def _small_clip(hidden_act: str, seed: int = 0):
    from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection

    torch.manual_seed(seed)
    cfg = CLIPVisionConfig(
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        image_size=64,
        patch_size=16,
        projection_dim=32,
        hidden_act=hidden_act,
    )
    model = CLIPVisionModelWithProjection(cfg)
    model.eval()
    return model


def _reference_pixel_values(frames_u8: np.ndarray, params: dict) -> torch.Tensor:
    """Replicate embed.py's preprocessing so torch sees identical pixels."""
    img = int(params["image_size"])
    x = jnp.asarray(frames_u8).astype(jnp.float32) / 255.0
    x = jax.image.resize(x, (x.shape[0], img, img, 3), method="bilinear")
    x = (x - jnp.asarray(params["image_mean"])) / jnp.asarray(params["image_std"])
    return torch.from_numpy(np.asarray(x).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("hidden_act", ["quick_gelu", "gelu"])
def test_converted_tower_matches_torch(tmp_path, hidden_act):
    model = _small_clip(hidden_act)
    params = convert_vision_model(model)
    assert params["act"] == np.asarray(_expected_act(hidden_act))
    assert "pre_ln/scale" in params  # CLIP's embedding layernorm survived

    path = tmp_path / "clip.npz"
    np.savez(path, **params)
    embedder = embed.VisionEmbedder(path)
    assert embedder.act == _expected_act(hidden_act)

    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, size=(2, 512, 512, 3), dtype=np.uint8)
    # strict parity: force f32 matmuls (an accelerator may default to
    # reduced-precision passes, TF32 on the GPU)
    with jax.default_matmul_precision("float32"):
        ours = embedder.embed_frames(frames)

    with torch.no_grad():
        out = model(pixel_values=_reference_pixel_values(frames, params))
    theirs = out.image_embeds.numpy()
    theirs = theirs / np.linalg.norm(theirs, axis=-1, keepdims=True)

    np.testing.assert_allclose(ours, theirs, atol=2e-4, rtol=2e-3)
    cos = (ours * theirs).sum(axis=-1)
    assert np.all(cos > 0.999999), cos

    # production path (default precision, possibly reduced on an accelerator) stays embedding-faithful
    fast = embedder.embed_frames(frames)
    assert np.all((fast * theirs).sum(axis=-1) > 0.9999)


def _expected_act(hidden_act: str) -> str:
    return {"quick_gelu": "quick_gelu", "gelu": "gelu"}[hidden_act]


def test_synthetic_checkpoints_still_load(tmp_path):
    # pre-existing checkpoints (no act/pre_ln keys) keep their behavior
    rng = np.random.default_rng(3)
    p = embed.make_synthetic_params(rng)
    path = tmp_path / "synth.npz"
    np.savez(path, **p)
    e = embed.VisionEmbedder(path)
    assert e.act == "gelu_tanh"
    frames = rng.integers(0, 256, size=(1, 512, 512, 3), dtype=np.uint8)
    emb = e.embed_frames(frames)
    assert emb.shape == (1, 32)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-5)
