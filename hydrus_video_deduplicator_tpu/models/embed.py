"""Jittable vision-embedding tower for candidate-pair reranking.

The BASELINE stretch goal: after the pHash prefilter finds candidate
duplicate pairs, a learned embedding (e.g. CLIP's vision tower) reranks
them by cosine similarity — catching perceptual-hash false positives and
confirming true duplicates across heavier transforms.

This module is the device mechanism: a standard pre-norm ViT whose
parameters load from a single ``.npz`` file, jitted end to end (patch
embedding and attention/MLP blocks are matrix products; the whole tower
runs on the device that already hashes the frames). No weights ship
with the framework (CLIP weights are not redistributable here); any ViT
checkpoint converted to the documented layout plugs in, and tests exercise
the full mechanism with synthetic weights.

``.npz`` layout (shapes define the architecture; D = width, P = patch):
    patch_embed/kernel [P, P, 3, D]     patch_embed/bias [D]
    cls_token [D]                       pos_embed [N_patches + 1, D]
    blocks.{i}.ln1/scale|bias [D]       blocks.{i}.ln2/scale|bias [D]
    blocks.{i}.attn/qkv_kernel [D, 3D]  blocks.{i}.attn/qkv_bias [3D]
    blocks.{i}.attn/out_kernel [D, D]   blocks.{i}.attn/out_bias [D]
    blocks.{i}.mlp/fc1_kernel [D, H]    blocks.{i}.mlp/fc1_bias [H]
    blocks.{i}.mlp/fc2_kernel [H, D]    blocks.{i}.mlp/fc2_bias [D]
    ln_final/scale|bias [D]             proj [D, E]
    n_heads [] (int)                    image_size [] (int, e.g. 224)
    image_mean [3], image_std [3] (pixel normalization, 0..1 scale)
Optional keys (present in CLIP-converted checkpoints, see convert_clip.py):
    pre_ln/scale|bias [D]   layernorm applied after pos_embed, before blocks
    act [] (str)            MLP activation: "gelu_tanh" (default),
                            "gelu" (erf, torch nn.GELU), "quick_gelu" (CLIP)
"""

from __future__ import annotations

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np


def load_params(path: str | Path) -> dict:
    """Load a ``.npz`` checkpoint into a plain dict of jnp arrays.

    The optional ``act`` entry is metadata, not a tensor; it stays a str.
    """
    with np.load(str(path)) as z:
        return {
            k: (str(z[k]) if k == "act" else jnp.asarray(z[k])) for k in z.files
        }


_ACTIVATIONS = {
    "gelu_tanh": jax.nn.gelu,  # tanh approximation (jax default)
    "gelu": functools.partial(jax.nn.gelu, approximate=False),  # erf, torch nn.GELU
    "quick_gelu": lambda x: x * jax.nn.sigmoid(1.702 * x),  # original CLIP
}


def _layer_norm(x, scale, bias, eps=1e-5):
    mu = x.mean(axis=-1, keepdims=True)
    var = ((x - mu) ** 2).mean(axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + eps) * scale + bias


def _attention(x, p, i, n_heads):
    b, n, d = x.shape
    qkv = x @ p[f"blocks.{i}.attn/qkv_kernel"] + p[f"blocks.{i}.attn/qkv_bias"]
    q, k, v = jnp.split(qkv, 3, axis=-1)
    hd = d // n_heads

    def heads(t):
        return t.reshape(b, n, n_heads, hd).transpose(0, 2, 1, 3)

    q, k, v = heads(q), heads(k), heads(v)
    logits = (q @ k.transpose(0, 1, 3, 2)) / jnp.sqrt(jnp.float32(hd))
    out = jax.nn.softmax(logits, axis=-1) @ v  # [b, h, n, hd]
    out = out.transpose(0, 2, 1, 3).reshape(b, n, d)
    return out @ p[f"blocks.{i}.attn/out_kernel"] + p[f"blocks.{i}.attn/out_bias"]


def _block(x, p, i, n_heads, act_fn):
    h = _layer_norm(x, p[f"blocks.{i}.ln1/scale"], p[f"blocks.{i}.ln1/bias"])
    x = x + _attention(h, p, i, n_heads)
    h = _layer_norm(x, p[f"blocks.{i}.ln2/scale"], p[f"blocks.{i}.ln2/bias"])
    h = act_fn(h @ p[f"blocks.{i}.mlp/fc1_kernel"] + p[f"blocks.{i}.mlp/fc1_bias"])
    return x + (h @ p[f"blocks.{i}.mlp/fc2_kernel"] + p[f"blocks.{i}.mlp/fc2_bias"])


def n_layers(params: dict) -> int:
    return 1 + max(
        int(k.split(".")[1].split("/")[0].split(".")[0])
        for k in params
        if k.startswith("blocks.")
    )


@functools.partial(jax.jit, static_argnames=("layers", "heads", "img", "act"))
def _embed(frames_u8, params, layers: int, heads: int, img: int, act: str = "gelu_tanh"):
    # frames: [B, 512, 512, 3] uint8 (the pipeline's decoded frames) ->
    # resize to the tower's input, normalize with the checkpoint's stats
    x = frames_u8.astype(jnp.float32) / 255.0
    x = jax.image.resize(x, (x.shape[0], img, img, 3), method="bilinear")
    x = (x - params["image_mean"]) / params["image_std"]

    kern = params["patch_embed/kernel"]
    patch = kern.shape[0]
    x = jax.lax.conv_general_dilated(
        x,
        kern,
        window_strides=(patch, patch),
        padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    ) + params["patch_embed/bias"]
    b = x.shape[0]
    x = x.reshape(b, -1, x.shape[-1])  # [B, N, D]
    cls = jnp.broadcast_to(params["cls_token"], (b, 1, x.shape[-1]))
    x = jnp.concatenate([cls, x], axis=1) + params["pos_embed"]
    if "pre_ln/scale" in params:  # CLIP's embedding layernorm
        x = _layer_norm(x, params["pre_ln/scale"], params["pre_ln/bias"])
    act_fn = _ACTIVATIONS[act]
    for i in range(layers):
        x = _block(x, params, i, heads, act_fn)
    x = _layer_norm(x, params["ln_final/scale"], params["ln_final/bias"])
    emb = x[:, 0, :] @ params["proj"]  # class token -> embedding space
    return emb / jnp.linalg.norm(emb, axis=-1, keepdims=True)


class VisionEmbedder:
    """Embeds decoded 512x512 frames with a ViT checkpoint; jitted."""

    def __init__(self, weights_path: str | Path):
        self.params = load_params(weights_path)
        self.act = self.params.pop("act", "gelu_tanh")
        self.layers = n_layers(self.params)
        self.heads = int(self.params["n_heads"])
        self.img = int(self.params["image_size"])

    def embed_frames(self, frames_u8: np.ndarray) -> np.ndarray:
        """[B, 512, 512, 3] uint8 -> [B, E] L2-normalized float32."""
        return np.asarray(
            _embed(
                jnp.asarray(frames_u8),
                self.params,
                self.layers,
                self.heads,
                self.img,
                self.act,
            )
        )

    def embed_video(self, frames_u8: np.ndarray) -> np.ndarray:
        """Video embedding = normalized mean of frame embeddings."""
        e = self.embed_frames(frames_u8).mean(axis=0)
        n = np.linalg.norm(e)
        return e / n if n > 0 else e


def make_synthetic_params(
    rng: np.random.Generator,
    width: int = 64,
    layers: int = 2,
    heads: int = 4,
    patch: int = 32,
    image_size: int = 224,
    embed_dim: int = 32,
    pixel_identity: bool = False,
) -> dict:
    """Random (or pixel-passthrough) checkpoint for tests/benchmarks.

    pixel_identity=True zeroes the transformer so the embedding is a pure
    function of mean patch pixels — visually similar videos then embed
    close together, letting tests assert rerank *semantics* without real
    trained weights.
    """
    n_patches = (image_size // patch) ** 2
    hidden = width * 4

    def r(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    p = {
        "patch_embed/kernel": r(patch, patch, 3, width),
        "patch_embed/bias": np.zeros(width, np.float32),
        "cls_token": r(width),
        "pos_embed": r(n_patches + 1, width),
        "ln_final/scale": np.ones(width, np.float32),
        "ln_final/bias": np.zeros(width, np.float32),
        "proj": r(width, embed_dim),
        "n_heads": np.asarray(heads),
        "image_size": np.asarray(image_size),
        "image_mean": np.asarray([0.48, 0.46, 0.41], np.float32),
        "image_std": np.asarray([0.27, 0.26, 0.28], np.float32),
    }
    for i in range(layers):
        p[f"blocks.{i}.ln1/scale"] = np.ones(width, np.float32)
        p[f"blocks.{i}.ln1/bias"] = np.zeros(width, np.float32)
        p[f"blocks.{i}.ln2/scale"] = np.ones(width, np.float32)
        p[f"blocks.{i}.ln2/bias"] = np.zeros(width, np.float32)
        if pixel_identity:
            # mean-pool attention: q = k = 0 (uniform softmax), v = out = I,
            # so every token (incl. cls) accumulates the mean patch content
            qkv = np.zeros((width, 3 * width), np.float32)
            qkv[:, 2 * width :] = np.eye(width, dtype=np.float32)
            p[f"blocks.{i}.attn/qkv_kernel"] = qkv
            p[f"blocks.{i}.attn/out_kernel"] = np.eye(width, dtype=np.float32)
            p[f"blocks.{i}.mlp/fc1_kernel"] = np.zeros((width, hidden), np.float32)
            p[f"blocks.{i}.mlp/fc2_kernel"] = np.zeros((hidden, width), np.float32)
        else:
            p[f"blocks.{i}.attn/qkv_kernel"] = r(width, 3 * width)
            p[f"blocks.{i}.attn/out_kernel"] = r(width, width)
            p[f"blocks.{i}.mlp/fc1_kernel"] = r(width, hidden)
            p[f"blocks.{i}.mlp/fc2_kernel"] = r(hidden, width)
        p[f"blocks.{i}.attn/qkv_bias"] = np.zeros(3 * width, np.float32)
        p[f"blocks.{i}.attn/out_bias"] = np.zeros(width, np.float32)
        p[f"blocks.{i}.mlp/fc1_bias"] = np.zeros(hidden, np.float32)
        p[f"blocks.{i}.mlp/fc2_bias"] = np.zeros(width, np.float32)
    if pixel_identity:
        # patch embed becomes a mean-pixel projector with stable scale
        k = np.zeros((patch, patch, 3, width), np.float32)
        for c in range(3):
            k[:, :, c, c::3] = 1.0 / (patch * patch)
        p["patch_embed/kernel"] = k
    return p
