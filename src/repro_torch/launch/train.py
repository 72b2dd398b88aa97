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

``--mesh host`` runs on the one device.  ``--mesh pod|multipod`` (the
reference's production meshes) needs the sharding rules and the pod mesh,
which the next slice of the port brings (ROADMAP Queue 1 item 8): it raises,
and never runs on one device instead.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.distributed.fault_tolerance import ResilientLoop
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.data import TokenStream, TokenStreamConfig
from repro_torch.training.train_step import make_train_step
from repro_torch.zoo.configs import get_config
from repro_torch.zoo.configs.base import leaves, materialize, model_spec_tree
from repro_torch.zoo.models.transformer import params_from_numpy


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

    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the production meshes need the sharding rules and "
            "launch/mesh.py:make_production_mesh, which the port's next slice brings "
            "(ROADMAP Queue 1 item 8); --mesh host runs on one device")
    dev = resolve_device(device)
    cfg = get_config(args.arch, smoke=args.smoke)

    optimizer = opt_mod.AdamW(lr=args.lr, weight_decay=0.1)
    step_fn = make_train_step(cfg, optimizer, microbatches=args.microbatches, remat=True)

    tree = materialize(model_spec_tree(cfg), torch.Generator(dev).manual_seed(0), torch.float32)
    params = params_from_numpy(tree, cfg, dev, trainable=True)
    del tree
    opt_state = optimizer.init(leaves(params))
    n_enc = cfg.encoder_seq or cfg.cross_seq

    def loop_step(state, batch):
        params, opt_state = state
        b = {"tokens": torch.as_tensor(batch, device=dev)}
        if n_enc:
            b["enc_input"] = torch.zeros((batch.shape[0], n_enc, cfg.d_model),
                                         dtype=torch.bfloat16, device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, b)
        return (params, opt_state), metrics

    stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                                           global_batch=args.global_batch))
    loop = ResilientLoop(loop_step, (params, opt_state), ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, device=dev)
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
