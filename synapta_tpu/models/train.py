"""Recognizer training: CTC on synthetic text lines, data-parallel over a
device mesh.

The training step is the framework's flagship multi-chip program: batch
sharded over the mesh 'data' axis via shard_map-style NamedSharding
constraints, gradients all-reduced by XLA from the sharding annotations
(no hand-written collectives needed for DP).

Run:  python -m synapta_tpu.models.train --steps 1500 \
          --out synapta_tpu/models/weights/recognizer.npz
"""
from __future__ import annotations

import argparse
import os
import time
from functools import partial
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from synapta_tpu.models import npz
from synapta_tpu.models.charset import BLANK, NUM_CLASSES, decode_greedy
from synapta_tpu.models.recognizer import init_recognizer, recognize
from synapta_tpu.models.synthdata import make_batch
from synapta_tpu.utils.jaxsetup import setup_jax

WEIGHTS_PATH = os.path.join(
    os.path.dirname(__file__), "weights", "recognizer.npz"
)


def init_params(rng_key, width=384) -> Dict[str, Any]:
    return init_recognizer(rng_key, width=width)


def ctc_objective(params, imgs, labels, label_lens):
    logits = recognize(params, imgs)  # (B, T, C)
    B, T, _ = logits.shape
    logit_pad = jnp.zeros((B, T), jnp.float32)  # no frame padding
    label_pad = (
        jnp.arange(labels.shape[1])[None, :] >= label_lens[:, None]
    ).astype(jnp.float32)
    loss = optax.ctc_loss(logits, logit_pad, labels, label_pad, blank_id=BLANK)
    return jnp.mean(loss)


def make_train_step(tx, mesh: Mesh | None = None):
    """Returns a jitted (params, opt_state, batch) -> (params, opt_state, loss).

    With a mesh, inputs/outputs carry NamedShardings: batch sharded on
    'data', params replicated — XLA inserts the gradient psums.
    """

    def step(params, opt_state, imgs, labels, label_lens):
        loss, grads = jax.value_and_grad(ctc_objective)(
            params, imgs, labels, label_lens
        )
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    if mesh is None:
        return jax.jit(step, donate_argnums=(0, 1))

    repl = NamedSharding(mesh, P())
    data = NamedSharding(mesh, P("data"))
    return jax.jit(
        step,
        in_shardings=(repl, repl, data, data, data),
        out_shardings=(repl, repl, repl),
        donate_argnums=(0, 1),
    )


def greedy_decode(params, imgs) -> list:
    logits = recognize(params, imgs)
    best = jnp.argmax(logits, axis=-1)
    probs = jax.nn.softmax(logits, axis=-1)
    conf = jnp.max(probs, axis=-1)  # (B, T)
    return np.asarray(best), np.asarray(conf)


def cer(ref: str, hyp: str) -> float:
    """Levenshtein character error rate."""
    if not ref:
        return 0.0 if not hyp else 1.0
    m, n = len(ref), len(hyp)
    dp = list(range(n + 1))
    for i in range(1, m + 1):
        prev = dp[0]
        dp[0] = i
        for j in range(1, n + 1):
            cur = dp[j]
            dp[j] = min(
                dp[j] + 1, dp[j - 1] + 1, prev + (ref[i - 1] != hyp[j - 1])
            )
            prev = cur
    return dp[n] / m


def evaluate(params, rng, n_batches=4, batch=64) -> float:
    from synapta_tpu.models import charset

    total = 0.0
    count = 0
    for _ in range(n_batches):
        imgs, labels, lens = make_batch(rng, batch=batch)
        best, _ = greedy_decode(params, imgs)
        for i in range(batch):
            ref = "".join(
                charset.ID_TO_CHAR.get(int(c), "") for c in labels[i][: lens[i]]
            )
            hyp = decode_greedy(best[i])
            total += cer(ref, hyp)
            count += 1
    return total / max(count, 1)


def pad_params(old_params, new_params):
    """Warm-start across an APPEND-ONLY charset extension: every leaf of
    the old checkpoint is copied into the freshly initialized tree; leaves
    whose shapes grew (the CTC head's Dense kernel/bias gaining classes)
    are copied into the overlapping slice, leaving fresh init in the new
    tail. Valid only because charset extension preserves old class ids."""
    import jax.tree_util as jtu

    flat_old = dict(jtu.tree_flatten_with_path(old_params)[0])
    new_leaves, treedef = jtu.tree_flatten_with_path(new_params)
    out = []
    for path, leaf in new_leaves:
        old = flat_old.get(path)
        if old is None or old.shape == leaf.shape:
            out.append(np.asarray(old) if old is not None else leaf)
            continue
        if len(old.shape) != len(leaf.shape):
            raise ValueError(f"rank mismatch at {path}")
        merged = np.array(leaf)
        sl = tuple(slice(0, min(a, b)) for a, b in zip(old.shape, leaf.shape))
        merged[sl] = np.asarray(old)[sl]
        out.append(merged)
    return jtu.tree_unflatten(treedef, out)


def save_params(params, path: str = WEIGHTS_PATH) -> None:
    npz.save_params(params, path)


def load_params(path: str = WEIGHTS_PATH):
    """Template-free restore. A checkpoint older than the current charset
    has a narrower CTC head; it is padded to NUM_CLASSES with zero kernel
    columns and -1e4 bias so the new classes can never win the argmax —
    the checkpoint behaves exactly as it did before the extension."""
    params = npz.load_params(path)
    head = params.get("Dense_0", {})
    k = head.get("kernel")
    if k is not None and k.shape[-1] < NUM_CLASSES:
        pad = NUM_CLASSES - k.shape[-1]
        head["kernel"] = np.concatenate(
            [np.asarray(k), np.zeros((k.shape[0], pad), k.dtype)], axis=-1
        )
        b = np.asarray(head["bias"])
        head["bias"] = np.concatenate([b, np.full((pad,), -1e4, b.dtype)])
    return params


def train(
    steps: int = 1500,
    batch: int = 64,
    lr: float = 3e-4,
    seed: int = 0,
    out: str = WEIGHTS_PATH,
    use_mesh: bool = False,
    log_every: int = 100,
    init_from: str | None = None,
    data: str = "pil",
    shot_frac: float = 0.16,
) -> float:
    setup_jax()
    if init_from:
        # template-free restore: the checkpoint may predate a charset
        # extension, so its head is narrower than the current model's —
        # pad_params copies it into a fresh init (append-only class ids)
        raw = npz.load_params(init_from)
        params = pad_params(raw, init_params(jax.random.PRNGKey(seed)))
    else:
        params = init_params(jax.random.PRNGKey(seed))
    tx = optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, lr, 100, steps), 0.9, 0.98
    )
    opt_state = tx.init(params)
    mesh = None
    if use_mesh:
        mesh = Mesh(np.array(jax.devices()), ("data",))
    step_fn = make_train_step(tx, mesh)
    rng = np.random.default_rng(seed)
    if data == "mixed":
        from synapta_tpu.models.synthdata import make_batch_mixed
        gen = lambda r, batch: make_batch_mixed(  # noqa: E731
            r, batch=batch, shot_frac=shot_frac)
    else:
        gen = lambda r, batch: make_batch(  # noqa: E731
            r, batch=batch, shot_frac=shot_frac)
    t0 = time.time()
    loss = None
    for s in range(steps):
        imgs, labels, lens = gen(rng, batch)
        params, opt_state, loss = step_fn(params, opt_state, imgs, labels, lens)
        if (s + 1) % log_every == 0:
            print(
                f"step {s + 1}/{steps} loss {float(loss):.4f} "
                f"({(time.time() - t0) / (s + 1):.3f}s/step)",
                flush=True,
            )
            # periodic checkpoint: a wall-clock cap must not lose a long
            # run (save is ~5MB, negligible)
            save_params(params, out)
    final_cer = evaluate(params, np.random.default_rng(seed + 1))
    print(f"eval CER: {final_cer:.4f}")
    save_params(params, out)
    print(f"saved -> {out}")
    return final_cer


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=WEIGHTS_PATH)
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--init-from", default=None)
    ap.add_argument("--data", default="pil", choices=["pil", "mixed"])
    ap.add_argument("--shot-frac", type=float, default=0.16)
    args = ap.parse_args()
    train(args.steps, args.batch, args.lr, args.seed, args.out, args.mesh,
          init_from=args.init_from, data=args.data, shot_frac=args.shot_frac)
