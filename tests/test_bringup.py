"""Portability of the main path: plain-JAX models equal to the flax modules
their weights were trained with, .npz weights, the Pillow-free resampler,
the compile-cache choice, the smoke run's device guard, k-means precision,
and a pipeline run with flax, Pillow and msgpack unimportable."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from synapta_tpu.models.detector import DET_WEIGHTS_PATH
from synapta_tpu.models.npz import load_params, save_params
from synapta_tpu.models.train import WEIGHTS_PATH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flax_modules():
    """The flax modules the checked-in weights were trained with."""
    nn = pytest.importorskip("flax.linen")

    class EncoderBlock(nn.Module):
        dim: int
        dtype: object = jnp.bfloat16

        @nn.compact
        def __call__(self, x):
            h = nn.LayerNorm(dtype=self.dtype)(x)
            h = nn.MultiHeadDotProductAttention(
                num_heads=4, dtype=self.dtype, qkv_features=self.dim)(h, h)
            x = x + h
            h = nn.LayerNorm(dtype=self.dtype)(x)
            h = nn.Dense(self.dim * 2, dtype=self.dtype)(h)
            h = nn.Dense(self.dim, dtype=self.dtype)(nn.gelu(h))
            return x + h

    class Recognizer(nn.Module):
        dim: int = 192
        dtype: object = jnp.bfloat16

        @nn.compact
        def __call__(self, x):
            def conv(f, s):
                return nn.Conv(f, (3, 3), strides=s, padding="SAME",
                               dtype=self.dtype)
            x = x.astype(self.dtype)
            for f, s in ((32, (1, 1)), (64, (2, 2)), (128, (2, 2)),
                         (self.dim, (2, 1)), (self.dim, (2, 1))):
                x = nn.relu(conv(f, s)(x))
            x = jnp.mean(x, axis=1)
            pos = self.param("pos_embed", nn.initializers.normal(0.02),
                             (1, x.shape[1], self.dim))
            x = x + pos.astype(self.dtype)
            for _ in range(2):
                x = EncoderBlock(dim=self.dim, dtype=self.dtype)(x)
            x = nn.LayerNorm(dtype=self.dtype)(x)
            return nn.Dense(161, dtype=jnp.float32)(x)

    class ConvBlock(nn.Module):
        features: int
        stride: int = 1
        dtype: object = jnp.bfloat16

        @nn.compact
        def __call__(self, x):
            x = nn.Conv(self.features, (3, 3), strides=(self.stride,) * 2,
                        padding="SAME", use_bias=False, dtype=self.dtype)(x)
            x = nn.GroupNorm(num_groups=min(8, self.features),
                             dtype=self.dtype)(x)
            return nn.relu(x)

    class Detector(nn.Module):
        dtype: object = jnp.bfloat16

        @nn.compact
        def __call__(self, x):
            d = self.dtype
            x = x.astype(d)
            feats = []
            for f in (16, 32, 64, 96):  # modules named in creation order
                x = ConvBlock(f, 2, d)(x)
                x = ConvBlock(f, 1, d)(x)
                feats.append(x)
            c1, c2, c3, c4 = feats

            def up(t, like):
                return jax.image.resize(
                    t, (t.shape[0],) + like.shape[1:3] + (t.shape[3],),
                    "bilinear").astype(d)

            def lat(t, f):
                return nn.Conv(f, (1, 1), dtype=d, use_bias=False)(t)

            p3 = lat(c3, 64) + up(lat(c4, 64), c3)
            p2 = lat(c2, 32) + up(ConvBlock(32, 1, d)(p3), c2)
            p1 = lat(c1, 16) + up(ConvBlock(16, 1, d)(p2), c1)
            h = ConvBlock(16, 1, d)(p1)
            return nn.Conv(2, (3, 3), padding="SAME", dtype=jnp.float32)(h)

    return Recognizer, Detector


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_plain_recognizer_equals_flax_on_checked_in_weights():
    from synapta_tpu.models.recognizer import recognize

    Recognizer, _ = _flax_modules()
    params = load_params(WEIGHTS_PATH)
    x = np.random.default_rng(0).random((2, 32, 384, 1)).astype(np.float32)
    ref = jax.jit(lambda p, x: Recognizer().apply({"params": p}, x))(
        params, x)
    got = jax.jit(recognize)(params, x)
    assert got.dtype == ref.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_plain_detector_equals_flax_on_checked_in_weights():
    from synapta_tpu.models.detector import detect_maps

    _, Detector = _flax_modules()
    params = load_params(DET_WEIGHTS_PATH)
    x = np.random.default_rng(1).random((1, 256, 256, 1)).astype(np.float32)
    ref = jax.jit(lambda p, x: Detector().apply({"params": p}, x))(params, x)
    got = jax.jit(detect_maps)(params, x)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("init", ["recognizer", "detector"])
def test_fresh_init_has_the_checked_in_tree(init):
    """init_* builds the same paths and shapes the weights carry, so
    training from scratch writes files the loaders read back."""
    from synapta_tpu.models.detector import init_detector
    from synapta_tpu.models.recognizer import init_recognizer

    fresh = (init_recognizer if init == "recognizer" else init_detector)(
        jax.random.PRNGKey(0))
    stored = load_params(WEIGHTS_PATH if init == "recognizer"
                         else DET_WEIGHTS_PATH)
    a, b = _leaves(fresh), _leaves(stored)
    assert a.keys() == b.keys()
    assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
               for k in a)


def test_npz_roundtrip_keeps_every_leaf(tmp_path):
    tree = load_params(WEIGHTS_PATH)
    tree["extra"] = {"ints": np.arange(5, dtype=np.int32),
                     "half": np.ones((2, 3), np.float16),
                     "scalar": np.float64(2.5)}
    path = str(tmp_path / "w.npz")
    save_params(tree, path)
    back = load_params(path)
    a, b = _leaves(tree), _leaves(back)
    assert list(a) == list(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError):
        save_params({"a/b": np.zeros(1)}, path)


@pytest.mark.parametrize("shape,out", [
    ((37, 53), (512, 512)),     # DB canvas upscale
    ((900, 700), (512, 512)),   # downscale
    ((300, 1200), (543, 2173)), # native-resolution detection resize
    ((28, 9), (28, 384)),       # width-only
])
def test_native_resize_matches_pillow(shape, out):
    """The Pillow-free DB tile resize agrees with Pillow's BILINEAR within
    one grey level (the native resampler is in fact pixel-identical)."""
    from PIL import Image

    from synapta_tpu.io.ingest import resize_gray

    rng = np.random.default_rng(sum(shape))
    g = rng.integers(0, 256, shape).astype(np.uint8)
    g[: shape[0] // 2] = 255 - g[: shape[0] // 2] // 4  # text-like contrast
    ref = np.asarray(Image.fromarray(g).resize((out[1], out[0]),
                                               Image.BILINEAR))
    got = resize_gray(g, out[0], out[1])
    assert got.shape == ref.shape
    assert int(np.abs(got.astype(int) - ref.astype(int)).max()) <= 1


def test_compile_cache_dir_selection():
    from synapta_tpu.utils.jaxsetup import DEFAULT_CACHE_DIR, compile_cache_dir

    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/cache",
                              "JAX_PLATFORMS": "cpu"}) == "/x/cache"
    gpu = compile_cache_dir({})
    assert gpu == DEFAULT_CACHE_DIR
    assert DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    cpu = compile_cache_dir({"JAX_PLATFORMS": "cpu"})
    assert os.path.dirname(cpu) == DEFAULT_CACHE_DIR
    assert os.path.basename(cpu).startswith("cpu-")
    assert compile_cache_dir({"JAX_PLATFORMS": "cpu"}) == cpu  # stable


def test_setup_jax_leaves_an_env_cache_alone(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, setup_jax sets nothing: the
    cache directory and thresholds stay JAX's own."""
    code = (
        "import jax\n"
        "from synapta_tpu.utils.jaxsetup import setup_jax\n"
        "before = (jax.config.jax_compilation_cache_dir,\n"
        "          jax.config.jax_persistent_cache_min_compile_time_secs)\n"
        "setup_jax()\n"
        "after = (jax.config.jax_compilation_cache_dir,\n"
        "         jax.config.jax_persistent_cache_min_compile_time_secs)\n"
        "print(before == after, after[0])\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["True", str(tmp_path)]


def test_chip_smoke_refuses_a_cpu_backend():
    sys.path.insert(0, REPO)
    import chip_smoke

    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.require_gpu("cpu")
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.require_gpu(jax.default_backend())  # this suite: cpu
    chip_smoke.require_gpu("gpu")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    """Run as a script on the CPU backend — inside the checkout, or copied
    alone into an empty directory — it exits non-zero and prints no
    result line."""
    import shutil

    cwd = REPO
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _kmeans_f64(rgb, k=5, iters=10, sample=4096):
    """float64 numpy rendering of ops/kmeans.dominant_colors for one image
    (same sample, maximin seeding and Lloyd steps)."""
    f = rgb.astype(np.float64)
    v, c = f.max(-1), f.max(-1) - f.min(-1)
    mask = ((255 * c > 30 * v) & (v > 40) & (v < 240)).reshape(-1)
    mask = mask.astype(np.float64)
    flat = rgb.reshape(-1, 3)
    n = mask.shape[0]
    perm = ((np.arange(n, dtype=np.uint64) * 2654435761) % n).astype(np.int64)
    rgb_p, mask_p = flat[perm], mask[perm]
    idx = np.argsort(1.0 - mask_p, kind="stable")[:sample]
    x = rgb_p[idx].astype(np.float64)
    w = mask_p[idx]
    c = np.zeros((k, 3))
    c[0] = x[0]
    dmin = ((x - x[0]) ** 2).sum(-1) * w
    for i in range(1, k):
        c[i] = x[np.argmax(dmin)]
        dmin = np.minimum(dmin, ((x - c[i]) ** 2).sum(-1) * w)
    for _ in range(iters + 1):
        d = ((x[:, None, :] - c[None]) ** 2).sum(-1)
        onehot = np.eye(k)[d.argmin(-1)] * w[:, None]
        cnt = onehot.sum(0)
        new = (onehot.T @ x) / np.maximum(cnt, 1.0)[:, None]
        if _ < iters:
            c = np.where(cnt[:, None] > 0, new, c)
    return c, cnt


def test_kmeans_highest_precision_matches_float64():
    from synapta_tpu.ops.kmeans import dominant_colors

    rng = np.random.default_rng(4)
    palette = np.array([[200, 30, 30], [30, 160, 40], [40, 60, 200],
                        [220, 200, 20], [150, 40, 170]], np.float64)
    lab = rng.integers(0, 5, (64, 64))
    img = np.clip(palette[lab] + rng.normal(0, 6, (64, 64, 3)), 0, 255)
    img = img.astype(np.uint8)
    centers, counts, _ = dominant_colors(jnp.asarray(img[None]))
    c64, n64 = _kmeans_f64(img)
    np.testing.assert_array_equal(np.asarray(counts)[0], n64)
    np.testing.assert_allclose(np.asarray(centers)[0], c64, rtol=1e-5,
                               atol=1e-3)


def test_process_runs_without_flax_pillow_msgpack(tmp_path):
    """process() on a pre-generated book in a fresh interpreter whose
    sys.modules blocks flax, PIL and msgpack: none of them is reachable
    from the main path."""
    from synapta_tpu.io.pdf_writer import make_test_book

    pdf = str(tmp_path / "book.pdf")
    make_test_book(pdf, pages=4, seed=11)
    code = (
        "import sys\n"
        "for m in ('flax', 'PIL', 'msgpack'):\n"
        "    sys.modules[m] = None\n"
        "import json\n"
        "from synapta_tpu.config import PipelineConfig\n"
        "from synapta_tpu.llm.fake import DisabledClient\n"
        "from synapta_tpu.pipeline import VisualSegmentationPipeline\n"
        f"pipe = VisualSegmentationPipeline('blk', {pdf!r},\n"
        f"    output_dir={str(tmp_path / 'out')!r}, use_mermaid=False,\n"
        "    config=PipelineConfig(use_vision_llm=False),\n"
        "    llm_client=DisabledClient(), resume=False)\n"
        "segs = pipe.process()\n"
        "print(json.dumps({'segments': len(segs),\n"
        "                  'errors': pipe.stats.errors}))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               SYNAPTA_LOG_LEVEL="WARNING")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"segments": 3, "errors": 0}, res  # page 1 is text only


def test_loader_workers_stay_on_the_cpu():
    """Spawned prepare workers pin JAX to the CPU before any task runs,
    so they can never take an accelerator's memory."""
    from synapta_tpu.io.loader import loader_pool

    pool = loader_pool(1)
    env = pool.submit(os.getenv, "JAX_PLATFORMS").result(timeout=120)
    cuda = pool.submit(os.getenv, "CUDA_VISIBLE_DEVICES").result(timeout=120)
    assert (env, cuda) == ("cpu", "")


@pytest.fixture
def gpu_env():
    """Environment for a child process that may use the GPU; skips when
    this machine has none (decided here, at run time, not at import)."""
    try:
        ok = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                            timeout=30).returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        ok = False
    if not ok:
        pytest.skip("no NVIDIA GPU on this machine")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    return env


@pytest.mark.gpu
def test_gpu_recognizer_matches_cpu(gpu_env):
    """The recognizer's bf16 program on the GPU against the CPU on real
    text-line tiles: greedy argmax identical on >= 99% of frames, softmax
    within what bf16 itself costs on these tiles (the CPU's bf16-vs-f32
    difference), and never looser than 2e-2."""
    code = (
        "import functools, jax, jax.numpy as jnp, numpy as np\n"
        "from synapta_tpu.models.recognizer import recognize\n"
        "from synapta_tpu.models.synthdata import make_batch_spdf\n"
        "from synapta_tpu.models.train import load_params\n"
        "assert jax.default_backend() == 'gpu'\n"
        "p = load_params()\n"
        "x = make_batch_spdf(np.random.default_rng(0), batch=16)[0]\n"
        "f = jax.jit(lambda p, x, d: jax.nn.softmax(recognize(p, x, d)),\n"
        "            static_argnums=2)\n"
        "g = np.asarray(f(p, x, jnp.bfloat16))\n"
        "with jax.default_device(jax.devices('cpu')[0]):\n"
        "    c = np.asarray(f(p, x, jnp.bfloat16))\n"
        "    e = np.asarray(f(p, x, jnp.float32))\n"
        "print(float(np.abs(g - c).max()), float(np.abs(c - e).max()),\n"
        "      float((g.argmax(-1) == c.argmax(-1)).mean()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=gpu_env, cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    dmax, cost, same = map(float, out.stdout.split()[-3:])
    assert dmax <= max(2e-2, cost) and same >= 0.99, (dmax, cost, same)
