"""Roofline analysis over dry-run artifacts, for one NVIDIA H100 (the
reference's ``repro/launch/roofline.py``, which targets another chip).

    compute term    = FLOPs_dev / peak_FLOPs
    memory term     = bytes_dev / HBM_bw
    collective term = wire_bytes_dev / link_bw

All three in seconds per step, per device.  MODEL_FLOPS = 6·N·D (dense)
or 6·N_active·D (MoE) per trained token; for serve steps 2·N per
processed token.  The artifacts are the dry run's JSON files (one per
arch × shape cell: FLOPs, bytes accessed and collective bytes per device,
memory, mesh).

Run: ``python -m repro_torch.launch.roofline --dir <artifacts>``.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List

# NVIDIA H100 SXM constants (per GPU), from NVIDIA's H100 datasheet.
PEAK_FLOPS = 989e12        # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12           # HBM3 bytes/s
NVLINK_BW = 900e9          # NVLink 4 bytes/s per GPU (all links together)
HBM_BYTES = 80 * 2**30     # the fit limit for one GPU's live bytes


def model_flops(art: Dict[str, Any], chips: int) -> float:
    """Useful-model FLOPs per step per device."""
    from ..configs.shapes import SHAPES
    n_active = art["n_active_params"]
    sh = SHAPES[art["shape"]]
    if art["kind"] == "train":
        return 6.0 * n_active * sh.seq_len * sh.global_batch / chips
    if art["kind"] == "prefill":
        return 2.0 * n_active * sh.seq_len * sh.global_batch / chips
    # decode: one token per sequence in the batch
    return 2.0 * n_active * sh.global_batch / chips


def analyze(art: Dict[str, Any]) -> Dict[str, Any]:
    chips = art["mesh"]["n_devices"]
    terms = {"compute_s": art["flops_per_device"] / PEAK_FLOPS,
             "memory_s": art["bytes_accessed_per_device"] / HBM_BW,
             "collective_s": art["collective_bytes_per_device"] / NVLINK_BW}
    dominant = max(terms, key=terms.get)
    mf = model_flops(art, chips)
    useful = mf / art["flops_per_device"] if art["flops_per_device"] else 0.0
    bound = max(terms.values())
    # the 6·N·D yardstick overestimates for SSM/decode programs (per-layer
    # matmuls are small); the program cannot contain more useful work than
    # its compiled FLOPs, so cap the numerator at the measured compute.
    mf_eff = min(mf, art["flops_per_device"])
    mfu_bound = (mf_eff / PEAK_FLOPS) / bound if bound > 0 else 0.0
    mem = art["memory"]
    # live-bytes estimate: train/decode update params+opt / cache in
    # place, so the outputs alias the arguments; prefill's cache is new.
    live = mem["argument_bytes"] + mem["temp_bytes"] \
        + mem["generated_code_bytes"]
    if art["kind"] == "prefill":
        live += mem["output_bytes"]
    return {
        **{k: round(v, 6) for k, v in terms.items()},
        "dominant": dominant.replace("_s", ""),
        "model_flops_per_device": mf,
        "useful_flops_ratio": round(useful, 4),
        "roofline_fraction": round(min(mfu_bound, 1.0), 4),
        "live_gib": round(live / 2**30, 2),
        "hbm_fit_ok": live < HBM_BYTES,
    }


def load_artifacts(art_dir: str, mesh_tag: str = "singlepod"
                   ) -> List[Dict[str, Any]]:
    out = []
    for path in sorted(glob.glob(os.path.join(art_dir, f"{mesh_tag}__*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def table(art_dir: str, mesh_tag: str = "singlepod") -> str:
    rows = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "useful-FLOP ratio | roofline frac | HBM ok |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for art in load_artifacts(art_dir, mesh_tag):
        if "skipped" in art:
            rows.append(f"| {art['arch']} | {art['shape']} | — | — | — | "
                        f"skipped({art['skipped']}) | — | — | — |")
            continue
        a = analyze(art)
        rows.append(
            f"| {art['arch']} | {art['shape']} | {a['compute_s']:.4f} | "
            f"{a['memory_s']:.4f} | {a['collective_s']:.4f} | "
            f"{a['dominant']} | {a['useful_flops_ratio']:.3f} | "
            f"{a['roofline_fraction']:.3f} | "
            f"{'yes' if a['hbm_fit_ok'] else 'NO'} |")
    return "\n".join(rows)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    ap.add_argument("--mesh", default="singlepod")
    args = ap.parse_args()
    print(table(args.dir, args.mesh))
