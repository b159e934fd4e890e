"""CTC text-line recognizer, written as plain JAX functions over a
parameter tree.

The replacement for PaddleOCR's recognition stage (ref
pdf_image_segmentation.py:1092-1165): a conv stack collapses a
height-normalized line image into a frame sequence, a small self-attention
encoder contextualizes it, and a CTC head emits per-frame class logits.
PP-OCRv3's SVTR-style "conv + attention + CTC" recipe (PAPERS.md) at a
scale trainable on synthetic data in minutes.

The parameter tree keeps the layout the checked-in weights were trained
with (``Conv_0..4``, ``pos_embed``, ``EncoderBlock_i/{LayerNorm_0,1,
MultiHeadDotProductAttention_0/{query,key,value,out}, Dense_0,1}``,
``LayerNorm_0``, ``Dense_0``). Convolutions, matmuls and attention run in
bfloat16 with float32 parameters; LayerNorm statistics and the CTC head
run in float32.

Input:  (B, 32, W, 1) float32 in [0, 1]   (W = cfg.line_max_width)
Output: (B, W // 4, NUM_CLASSES) float32 logits
"""
from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp
from jax import lax

from synapta_tpu.models.charset import NUM_CLASSES

Params = Dict[str, Any]

LN_EPS = 1e-6
COMPUTE_DTYPE = jnp.bfloat16


# ------------------------------------------------------------------ layers


def conv(p: Params, x, stride=(1, 1), dtype=COMPUTE_DTYPE):
    """SAME-padded NHWC convolution with an HWIO kernel (+ bias if any)."""
    y = lax.conv_general_dilated(
        x.astype(dtype), p["kernel"].astype(dtype), stride, "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def dense(p: Params, x, dtype=COMPUTE_DTYPE):
    """x @ kernel + bias over the last axis."""
    y = lax.dot_general(
        x.astype(dtype), p["kernel"].astype(dtype),
        (((x.ndim - 1,), (0,)), ((), ())),
    )
    return y + p["bias"].astype(dtype)


def _normalize(x, mean, var, scale, bias, dtype):
    """(x - mean) * rsqrt(var + eps) * scale + bias in float32, cast to
    ``dtype``; mean/var already broadcast against x."""
    y = x.astype(jnp.float32) - mean
    y = y * (lax.rsqrt(var + LN_EPS) * scale.astype(jnp.float32))
    return (y + bias.astype(jnp.float32)).astype(dtype)


def _moments(x, axes):
    """float32 mean and E[x^2]-mean^2 variance (clipped at 0)."""
    x = x.astype(jnp.float32)
    mean = x.mean(axes, keepdims=True)
    var = jnp.maximum(0.0, (x * x).mean(axes, keepdims=True) - mean * mean)
    return mean, var


def layer_norm(p: Params, x, dtype=COMPUTE_DTYPE):
    mean, var = _moments(x, (-1,))
    return _normalize(x, mean, var, p["scale"], p["bias"], dtype)


def group_norm(p: Params, x, groups: int, dtype=COMPUTE_DTYPE):
    """GroupNorm over (H, W, C/groups) per sample, NHWC."""
    b, h, w, c = x.shape
    g = x.reshape(b, h, w, groups, c // groups)
    mean, var = _moments(g, (1, 2, 4))
    mean = jnp.repeat(mean, c // groups, axis=-1).reshape(b, 1, 1, c)
    var = jnp.repeat(var, c // groups, axis=-1).reshape(b, 1, 1, c)
    return _normalize(x, mean, var, p["scale"], p["bias"], dtype)


def attention(p: Params, x, dtype=COMPUTE_DTYPE):
    """Multi-head self-attention; q/k/v kernels are (D, heads, head_dim),
    the output kernel (heads, head_dim, D)."""
    def proj(name):
        q = p[name]
        y = lax.dot_general(x.astype(dtype), q["kernel"].astype(dtype),
                            (((x.ndim - 1,), (0,)), ((), ())))
        return y + q["bias"].astype(dtype)

    q, k, v = proj("query"), proj("key"), proj("value")  # (B, T, H, d)
    depth = q.shape[-1]
    q = q / jnp.sqrt(depth).astype(dtype)
    w = jnp.einsum("...qhd,...khd->...hqk", q, k)
    w = jax.nn.softmax(w).astype(dtype)
    o = jnp.einsum("...hqk,...khd->...qhd", w, v)
    out = p["out"]
    y = lax.dot_general(o, out["kernel"].astype(dtype),
                        (((o.ndim - 2, o.ndim - 1), (0, 1)), ((), ())))
    return y + out["bias"].astype(dtype)


def encoder_block(p: Params, x, dtype=COMPUTE_DTYPE):
    h = layer_norm(p["LayerNorm_0"], x, dtype)
    x = x + attention(p["MultiHeadDotProductAttention_0"], h, dtype)
    h = layer_norm(p["LayerNorm_1"], x, dtype)
    h = jax.nn.gelu(dense(p["Dense_0"], h, dtype), approximate=True)
    return x + dense(p["Dense_1"], h, dtype)


# ------------------------------------------------------------- recognizer


def recognize(params: Params, x, dtype=COMPUTE_DTYPE):
    """(B, 32, W, 1) float in [0, 1] -> (B, W // 4, classes) f32 logits."""
    relu = jax.nn.relu
    x = x.astype(dtype)
    x = relu(conv(params["Conv_0"], x, (1, 1), dtype))
    x = relu(conv(params["Conv_1"], x, (2, 2), dtype))   # 16 x W/2
    x = relu(conv(params["Conv_2"], x, (2, 2), dtype))   # 8 x W/4
    x = relu(conv(params["Conv_3"], x, (2, 1), dtype))   # 4 x W/4
    x = relu(conv(params["Conv_4"], x, (2, 1), dtype))   # 2 x W/4
    x = jnp.mean(x, axis=1)                              # (B, W/4, dim)
    x = x + params["pos_embed"].astype(dtype)
    i = 0
    while f"EncoderBlock_{i}" in params:
        x = encoder_block(params[f"EncoderBlock_{i}"], x, dtype)
        i += 1
    x = layer_norm(params["LayerNorm_0"], x, dtype)
    return dense(params["Dense_0"], x, jnp.float32)


# ----------------------------------------------------------------- init


def _lecun(key, shape, fan_in):
    return (jax.random.truncated_normal(key, -2.0, 2.0, shape, jnp.float32)
            * (1.0 / fan_in) ** 0.5 / 0.87962566103423978)


def init_conv(key, kh, kw, cin, cout, bias=True) -> Params:
    p = {"kernel": _lecun(key, (kh, kw, cin, cout), kh * kw * cin)}
    if bias:
        p["bias"] = jnp.zeros((cout,), jnp.float32)
    return p


def init_dense(key, cin, cout) -> Params:
    return {"kernel": _lecun(key, (cin, cout), cin),
            "bias": jnp.zeros((cout,), jnp.float32)}


def init_norm(c) -> Params:
    return {"scale": jnp.ones((c,), jnp.float32),
            "bias": jnp.zeros((c,), jnp.float32)}


def init_recognizer(key, width: int = 384, num_classes: int = NUM_CLASSES,
                    dim: int = 192, blocks: int = 2, heads: int = 4,
                    mlp_ratio: int = 2) -> Params:
    """Fresh parameters (lecun-normal kernels, zero biases, unit norms)."""
    keys = iter(jax.random.split(key, 8 + 6 * blocks))
    chans = [1, 32, 64, 128, dim, dim]
    p: Params = {
        f"Conv_{i}": init_conv(next(keys), 3, 3, chans[i], chans[i + 1])
        for i in range(5)
    }
    p["pos_embed"] = 0.02 * jax.random.normal(
        next(keys), (1, width // 4, dim), jnp.float32)
    hd = dim // heads
    for b in range(blocks):
        att = {
            n: {"kernel": _lecun(next(keys), (dim, heads, hd), dim),
                "bias": jnp.zeros((heads, hd), jnp.float32)}
            for n in ("query", "key", "value")
        }
        att["out"] = {"kernel": _lecun(next(keys), (heads, hd, dim), dim),
                      "bias": jnp.zeros((dim,), jnp.float32)}
        p[f"EncoderBlock_{b}"] = {
            "LayerNorm_0": init_norm(dim),
            "MultiHeadDotProductAttention_0": att,
            "LayerNorm_1": init_norm(dim),
            "Dense_0": init_dense(next(keys), dim, dim * mlp_ratio),
            "Dense_1": init_dense(next(keys), dim * mlp_ratio, dim),
        }
    p["LayerNorm_0"] = init_norm(dim)
    p["Dense_0"] = init_dense(next(keys), dim, num_classes)
    return p
