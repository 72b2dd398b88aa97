"""Roofline report builder (port of ``repro/roofline/report.py``).

Reads the dry-run artifacts
(``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json``) and derives, per
(arch x shape x mesh):

    compute term    = dot_FLOPs_per_device / PEAK_FLOPS
    memory term     = traffic_bytes_per_device / HBM_BW
    collective term = collective_bytes_per_device / link bandwidth

(per-device numbers: the counter bills each rank's local shards), plus
MODEL_FLOPS = 6*N*D (train) / 2*N*D (prefill) / 2*N_active*B (decode) and
the usefulness ratio MODEL_FLOPS / counted FLOPs.

Hardware: the NVIDIA H100 SXM's datasheet figures — 989 TFLOP/s dense bf16,
3.35 TB/s HBM3.  The fabric assumed: 8-GPU nodes joined inside by NVLink 4
(450 GB/s a GPU each way) and across by one 400 Gb/s NDR InfiniBand port a
GPU (50 GB/s).  A mesh whose widest axis is at most 8 ranks fits in a node
and its collectives run at the NVLink figure; the production meshes' axes
are 16 wide (the "model" axis of consecutive ranks spans two nodes, "data"
and "pod" cross nodes), so theirs run at the network figure.

    PYTHONPATH=src python -m repro_torch.roofline.report [--mesh pod]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.zoo.configs import get_config
from repro_torch.zoo.configs.shapes import SHAPES

PEAK_FLOPS = 989e12       # H100 SXM dense bf16, FLOP/s
HBM_BW = 3.35e12          # H100 SXM HBM3, bytes/s
NVLINK_BW = 450e9         # H100 SXM NVLink 4, bytes/s a GPU each way (axes <= 8 ranks)
NET_BW = 50e9             # one 400 Gb/s NDR port a GPU, bytes/s (axes across nodes)
NODE_GPUS = 8

ART_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def link_bw(widest_axis: int) -> float:
    """The H100 fabric's per-GPU collective bandwidth for a mesh whose
    widest axis has ``widest_axis`` ranks."""
    return NVLINK_BW if widest_axis <= NODE_GPUS else NET_BW


def model_flops(arch: str, shape: str, devices: int, *, cfg=None, spec=None) -> float:
    """Per-device useful FLOPs for the step this cell runs (``cfg``/``spec``:
    a config and a shape of their own in place of the registry's)."""
    if arch == "groot-gnn":
        # GraphSAGE inference over one re-grown partition per device:
        # L layers x (7 dense matmuls (self + 6 groups) + 6 edge
        # aggregations), unpadded node/edge counts.
        from repro_torch.launch.steps import GROOT_SHAPES

        gcfg = cfg or get_config(arch)
        bits, batch = spec or GROOT_SHAPES[shape]
        nodes = 8.0 * bits * bits * batch
        edges = 2 * nodes
        h = gcfg.gnn.hidden
        layers = gcfg.gnn.num_layers
        per_graph = layers * (7 * 2 * nodes * h * h + 6 * 2 * edges * h)
        return per_graph / devices
    cfg = cfg or get_config(arch)
    sh = spec or SHAPES[shape]
    n_active = cfg.active_param_count()
    if sh.kind == "train":
        tokens = sh.global_batch * sh.seq_len
        total = 6.0 * n_active * tokens
    elif sh.kind == "prefill":
        tokens = sh.global_batch * sh.seq_len
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * sh.global_batch
    return total / devices


def load_records(mesh: str, art_dir: Path = ART_DIR) -> list:
    out = []
    d = Path(art_dir) / mesh
    if not d.exists():
        return out
    for p in sorted(d.glob("*.json")):
        out.append(json.loads(p.read_text()))
    return out


def widest_axis(rec: dict) -> int:
    """The widest axis of the record's mesh (the production meshes': 16)."""
    from repro_torch.launch.mesh import PRODUCTION_MESHES

    if rec["mesh"] in ("pod", "multipod"):
        return max(PRODUCTION_MESHES[rec["mesh"] == "multipod"][0])
    return int(rec.get("widest_axis", rec["devices"]))


def terms(rec: dict) -> dict:
    h = rec["hlo"]
    compute = h["dot_flops_per_device"] / PEAK_FLOPS
    memory = h["traffic_bytes_per_device"] / HBM_BW
    collective = h["collective_bytes_per_device"] / link_bw(widest_axis(rec))
    dominant = max(
        ("compute", compute), ("memory", memory), ("collective", collective),
        key=lambda kv: kv[1],
    )[0]
    mf = model_flops(rec["arch"], rec["shape"], rec["devices"])
    dot = h["dot_flops_per_device"]
    bound = max(compute, memory, collective)
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
        "model_flops_per_device": mf,
        "useful_ratio": (mf / dot) if dot else 0.0,
        # roofline fraction: useful work over the time the dominant
        # bottleneck enforces (peak-compute-normalised)
        "roofline_fraction": (mf / PEAK_FLOPS) / bound if bound else 0.0,
    }


def build_table(mesh: str, art_dir: Path = ART_DIR) -> list:
    rows = []
    for rec in load_records(mesh, art_dir):
        t = terms(rec)
        mem = rec.get("memory_analysis", {})
        rows.append(
            {
                "arch": rec["arch"],
                "shape": rec["shape"],
                "mesh": rec["mesh"],
                "devices": rec["devices"],
                "trace_s": rec["timing"]["trace_s"],
                "hbm_gb_per_dev": round(mem.get("peak_bytes", 0) / 1e9, 2),
                **{k: (round(v, 4) if isinstance(v, float) else v) for k, v in t.items()},
            }
        )
    return rows


def to_markdown(rows: list) -> str:
    hdr = (
        "| arch | shape | mesh | peak GB/dev | compute s | memory s | "
        "collective s | dominant | useful ratio | roofline frac |\n"
        "|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['hbm_gb_per_dev']} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {r['collective_s']:.3f} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.3f} | "
            f"{r['roofline_fraction']:.4f} |"
        )
    return hdr + "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod", choices=("pod", "multipod"))
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--dir", default=str(ART_DIR), help="artifact directory")
    args = ap.parse_args(argv)
    rows = build_table(args.mesh, Path(args.dir))
    if args.json:
        print(json.dumps(rows, indent=1))
    else:
        print(to_markdown(rows))
    out = Path(args.dir) / f"roofline_{args.mesh}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    print(f"[saved {out}]")


if __name__ == "__main__":
    main()
