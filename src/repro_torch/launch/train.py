"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --smoke \\
        --steps 50 --ckpt-dir ckpt

Runs the fault-tolerant loop (heartbeats, straggler EWMA, async
checkpoints, resume-on-restart) on one device: ``cuda`` unless ``main`` is
given ``device="cpu"``.  The flags and the printed lines are the
reference's.  The params are drawn by the port's ``materialize`` from a
seeded ``torch.Generator`` over ``model_spec_tree`` (so the stacked leaves
take the reference's layer-count scale, ROADMAP Queue 3 item 5), held as f32
masters; the optimizer is ``AdamW(lr, weight_decay=0.1)``; the step is
``make_train_step(remat=True)`` over ``TokenStream`` batches; the encoder
archs get the reference's zeros stub input.  ``--ckpt-dir`` defaults to
``repro_ckpt`` in the temporary directory (``TMPDIR``).

``--mesh host`` runs on the one device.  ``--mesh pod|multipod`` runs one
rank of the reference's production mesh: it needs a 256- or 512-rank
``torchrun`` world (``MeshConfigError`` otherwise, naming the size), builds
``make_production_mesh``, places the params and the optimizer state by
``launch/steps.py``'s train shardings (:func:`place_train_state`: FSDP
over "data" and TP over "model") and trains under ``use_sharding``; the
batch is split over the batch axes.  The ranks share one checkpoint
directory, which every rank must see: rank 0 alone writes and reads the
state there, one leaf at a time, in the single-device format
(``checkpoint/manager.py``); each rank beats its own heartbeat file.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.distributed.fault_tolerance import ResilientLoop
from repro_torch.sharding.rules import is_dtensor, use_sharding
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.data import TokenStream, TokenStreamConfig
from repro_torch.training.train_step import make_train_step
from repro_torch.zoo.configs import get_config
from repro_torch.zoo.configs.base import leaves, materialize, model_spec_tree, tree_map
from repro_torch.zoo.models.transformer import params_from_numpy


def place_train_state(tree, cfg, mesh, optimizer):
    """The f32 masters of a materialised param tree and their optimizer
    state as DTensors on ``mesh``, placed by the train cells' shardings
    (``launch/steps.py``: FSDP over "data", TP over "model"; Q8 moments as
    their params).  Every rank passes the same ``tree``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.steps import _leaf_placements, opt_state_shardings
    from repro_torch.sharding.rules import as_dtensor, make_rules, tree_shardings

    spec = model_spec_tree(cfg)
    p_shard = tree_shardings(spec, mesh, make_rules(mesh, fsdp=True))
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)

    def place(a, pl):
        if a is None:
            return None
        t = torch.as_tensor(a).to(device=dev, dtype=torch.float32)
        return nn.Parameter(distribute_tensor(t, mesh, pl))

    params = tree_map(place, tree, p_shard)
    opt_state = optimizer.init(leaves(params))
    o_shard = opt_state_shardings(opt_state, _leaf_placements(p_shard), mesh)
    opt_state = tree_map(lambda z, pl: as_dtensor(z, mesh, pl), opt_state, o_shard)
    return params, opt_state


def shard_batch(batch: dict, mesh) -> dict:
    """A batch every rank holds alike, split over the batch axes."""
    from repro_torch.launch.steps import _batch_sharding
    from repro_torch.sharding.rules import as_dtensor

    return {k: as_dtensor(v, mesh, _batch_sharding(mesh, v.shape)) for k, v in batch.items()}


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="host", choices=("host", "pod", "multipod"))
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = get_config(args.arch, smoke=args.smoke)

    optimizer = opt_mod.AdamW(lr=args.lr, weight_decay=0.1)
    step_fn = make_train_step(cfg, optimizer, microbatches=args.microbatches, remat=True)

    mesh, rank = None, 0
    if args.mesh != "host":
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_production_mesh

        mesh = make_production_mesh(multi_pod=args.mesh == "multipod", device_type=dev.type)
        rank = dist.get_rank()
    tree = materialize(model_spec_tree(cfg), torch.Generator(dev).manual_seed(0), torch.float32)
    if mesh is None:
        params = params_from_numpy(tree, cfg, dev, trainable=True)
        opt_state = optimizer.init(leaves(params))
    else:
        params, opt_state = place_train_state(tree, cfg, mesh, optimizer)
    del tree
    n_enc = cfg.encoder_seq or cfg.cross_seq

    def loop_step(state, batch):
        params, opt_state = state
        b = {"tokens": torch.as_tensor(batch, device=dev)}
        if n_enc:
            b["enc_input"] = torch.zeros((batch.shape[0], n_enc, cfg.d_model),
                                         dtype=torch.bfloat16, device=dev)
        if mesh is not None:
            b = shard_batch(b, mesh)
        with use_sharding(mesh, fsdp=True):
            params, opt_state, metrics = step_fn(params, opt_state, b)
        metrics = {k: v.full_tensor() if is_dtensor(v) else v for k, v in metrics.items()}
        return (params, opt_state), metrics

    stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                                           global_batch=args.global_batch))
    loop = ResilientLoop(loop_step, (params, opt_state), ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, device=dev, host_id=rank)
    if loop.resumed:
        print(f"resumed from step {loop.step}")

    t0 = time.perf_counter()
    batches = (stream.batch_at(s) for s in range(loop.step, args.steps))
    for step, metrics in loop.run(batches, steps=args.steps):
        if step % args.log_every == 0:
            dt = time.perf_counter() - t0
            print(
                f"step {step:5d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} ({dt:.1f}s)",
                flush=True,
            )
    if loop.stragglers:
        print(f"straggler events: {len(loop.stragglers)}")
    print("done.")


if __name__ == "__main__":
    main()
