"""The correctness check's control: the reference computed with TF32
matrix products, one precision below the configurations' float32, has to
come out as not correct, while the program on its timed path stays within
the limits: its logits against the reference's on the program's own inputs,
and its classes against the reference's own derivation.  At csa-128 and booth-128 here; on the chip at 1,024 bits by
``bench/calibrate.py``.  On a CUDA device the control runs real TF32, on
the CPU its operands are rounded to TF32."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench.runners import gnn as runner  # noqa: E402
from bench.reference import generators as G  # noqa: E402
from repro_torch.api.config import SessionConfig  # noqa: E402
from repro_torch.api.session import Session  # noqa: E402
from repro_torch.core import aig as A  # noqa: E402
from repro_torch.core.gnn import GNNConfig  # noqa: E402


@pytest.mark.parametrize("config", ["csa-1024", "booth-1024"])
def test_tf32_control_fails_and_the_program_passes(config):
    cfg = json.loads((ROOT / "bench" / "configs" / f"{config}.json").read_text())
    limit, err_limit = cfg["check"]["max_logit_gap"], cfg["check"]["max_logit_error"]
    d = G.GENERATORS[cfg["design"]["generator"]](128)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    mix = {"session": {"num_partitions": 1, "memory_budget_bytes": None}}
    session = Session(config=SessionConfig(backend=cfg["backend"], gnn=GNNConfig(**cfg["gnn"]),
                                           device=device, mesh_devices=1))
    prep = session.prepare(A.AIG(name=d["name"], kind=d["kind"], fanin0=d["fanin0"],
                                 fanin1=d["fanin1"], label=d["label"], n_pi=d["n_pi"],
                                 pos=d["pos"]))
    for seed in (0, 1, 2):
        params = runner.make_params(cfg["gnn"], seed, torch.device(device))
        session.set_params(runner._numpy_tree(params))
        with runner.LogitCapture(params, tf32_control=True) as cap:
            pred = session.verify(prepared=prep, verify=False, use_cache=False,
                                  return_predictions=True).predictions
        assert cap.calls == 1
        assert cap.worst <= err_limit < cap.worst_tf32, seed
        want, _, _, _ = runner.reference_logits(d, params, cfg, mix, torch.device(device))
        low, _, _, _ = runner.reference_logits(d, params, cfg, mix, torch.device(device),
                                                tf32=True)
        assert runner.logit_gap(want, pred) <= limit, seed
        assert runner.logit_gap(want, low.argmax(1).cpu().numpy()) > limit, seed
