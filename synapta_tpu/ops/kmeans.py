"""Masked k-means for dominant-color extraction.

Replaces the sklearn KMeans call (ref pdf_image_segmentation.py:1566-1594):
pixels pass the reference's HSV mask (S > 30, 40 < V < 240), a fixed-size
sample is gathered, and k-means runs a fixed number of Lloyd iterations in a
fori_loop — static shapes throughout, distances as batched matmuls.
Batched over crops.

The matmuls run at HIGHEST precision: RGB values reach 255, so the
x2 - 2xc + c2 distances lose whole units under a reduced-precision
(TF32 or bf16) matmul, enough to flip a pixel's cluster.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax



def _sample_masked(rgb_flat: jnp.ndarray, mask_flat: jnp.ndarray, n: int):
    """Deterministically gather up to n masked pixels, spatially unbiased.

    A fixed odd-multiplier index bijection scatters pixel order before the
    masked-first stable sort — otherwise the sample would be the top rows
    of the image only. Returns (samples (n,3) float32, weights (n,))."""
    N = mask_flat.shape[0]
    i = jnp.arange(N, dtype=jnp.uint32)
    perm = ((i * jnp.uint32(2654435761)) % jnp.uint32(N)).astype(jnp.int32)
    rgb_p = rgb_flat[perm]
    mask_p = mask_flat[perm]
    order = jnp.argsort(1.0 - mask_p, stable=True)
    idx = order[:n]
    samples = rgb_p[idx].astype(jnp.float32)
    weights = mask_p[idx]
    return samples, weights


def dominant_colors(
    rgb: jnp.ndarray,
    k: int = 5,
    iters: int = 10,
    sample: int = 4096,
    sat_min: float = 30.0,
    val_range=(40.0, 240.0),
):
    """(B, H, W, 3) uint8 -> (centers (B, k, 3), counts (B, k), n_masked (B,)).

    Centers are RGB float32; counts are masked-pixel counts per cluster.
    """
    B = rgb.shape[0]
    # the reference's HSV mask (OpenCV ranges, ref :1574) in exact
    # arithmetic: S = 255 * (max - min) / max, so S > sat_min is
    # 255 * (max - min) > sat_min * max on integers below 2^24 — no
    # division whose rounding differs between backends
    f = rgb.astype(jnp.float32)
    v = jnp.max(f, axis=-1)
    c = v - jnp.min(f, axis=-1)
    mask = ((255.0 * c > sat_min * v) & (v > val_range[0])
            & (v < val_range[1]))
    rgb_flat = rgb.reshape(B, -1, 3)
    mask_flat = mask.reshape(B, -1).astype(jnp.float32)

    samples, weights = jax.vmap(lambda r, m: _sample_masked(r, m, sample))(
        rgb_flat, mask_flat
    )

    # init: deterministic farthest-point (maximin) seeding — avoids the
    # collapsed-cluster failure of naive stride sampling (sklearn uses
    # kmeans++ with n_init=10; maximin is its deterministic cousin)
    def maximin(samps, w):
        c0 = samps[0]
        centers0 = jnp.zeros((k, 3), samps.dtype).at[0].set(c0)
        d0 = jnp.sum((samps - c0) ** 2, axis=-1) * w

        def pick(i, state):
            centers, dmin = state
            nxt = samps[jnp.argmax(dmin)]
            centers = centers.at[i].set(nxt)
            d = jnp.sum((samps - nxt) ** 2, axis=-1) * w
            return centers, jnp.minimum(dmin, d)

        centers, _ = lax.fori_loop(1, k, pick, (centers0, d0))
        return centers

    init_centers = jax.vmap(maximin)(samples, weights)  # (B, k, 3)

    hi = lax.Precision.HIGHEST

    def lloyd(_, centers):
        # distances (B, n, k) via (x - c)^2 = x2 - 2xc + c2 (a matmul)
        x2 = jnp.sum(samples * samples, axis=-1, keepdims=True)
        c2 = jnp.sum(centers * centers, axis=-1)[:, None, :]
        xc = jnp.einsum("bnd,bkd->bnk", samples, centers, precision=hi)
        d = x2 - 2 * xc + c2
        assign = jnp.argmin(d, axis=-1)  # (B, n)
        onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32) * weights[..., None]
        sums = jnp.einsum("bnk,bnd->bkd", onehot, samples, precision=hi)
        cnts = jnp.sum(onehot, axis=1)  # (B, k)
        new = sums / jnp.maximum(cnts, 1.0)[..., None]
        return jnp.where(cnts[..., None] > 0, new, centers)

    centers = lax.fori_loop(0, iters, lloyd, init_centers)

    # final assignment for counts
    x2 = jnp.sum(samples * samples, axis=-1, keepdims=True)
    c2 = jnp.sum(centers * centers, axis=-1)[:, None, :]
    xc = jnp.einsum("bnd,bkd->bnk", samples, centers, precision=hi)
    assign = jnp.argmin(x2 - 2 * xc + c2, axis=-1)
    onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32) * weights[..., None]
    counts = jnp.sum(onehot, axis=1)
    n_masked = jnp.sum(mask_flat, axis=1)
    return centers, counts, n_masked


def colors_to_hex(centers, counts, n_masked, max_colors: int = 5):
    """Host: order clusters by size, drop empties, emit '#rrggbb' strings
    (ref emits hex codes, :1589-1592)."""
    import numpy as np

    centers = np.asarray(centers)
    counts = np.asarray(counts)
    out = []
    for i in np.argsort(-counts):
        if counts[i] <= 0:
            continue
        r, g, b = [int(max(0, min(255, round(c)))) for c in centers[i]]
        h = f"#{r:02x}{g:02x}{b:02x}"
        if h not in out:
            out.append(h)
        if len(out) >= max_colors:
            break
    return out if n_masked > 50 else out[:3] if n_masked > 10 else []
