"""Three-term roofline over the dry run's records.  Port of
``repro.roofline.analysis``.

Per (arch x shape x mesh), from rank 0's counted step
(:mod:`repro_torch.launch.dryrun`, :mod:`.hlo_stats`), against the
data-sheet peaks of one H100 SXM 80GB at 700 W:

  compute term    = sum over dtypes of dot_FLOPs / the dtype's dense peak
                    (float32 67 TFLOP/s: TF32 stays off, as the port sets
                    it; bfloat16 989 TFLOP/s) + kernel_ops / 1,979 TOP/s
                    (the BP/BS kernel's int8 plane operations)
  memory term     = (dot_bytes + kernel_bytes) / 3.35 TB/s (HBM3)
  collective term = sum over mesh axes of the axis's collective bytes /
                    the bandwidth of the link its group crosses: 450 GB/s
                    a direction on NVLink within an 8-card node, 50 GB/s
                    a card (400 Gb/s) between nodes

The memory term streams every dot's and kernel call's operands and
output once (the unfused upper bound ``result_bytes`` stays in the
records).  Collective bytes take max(operand, result) per op, as the
reference does.  The cards of a mesh are numbered row-major over its
axes and packed 8 to a node, so an axis's group crosses nodes when its
stride times (size - 1) reaches 8; the row names the links it uses.

Also reports MODEL_FLOPS = 6*N_active*D (2*N*D for inference,
:mod:`repro_torch.models.counting`) and the useful-work ratio
MODEL_FLOPS / (dot_FLOPs + kernel_ops): remat, redundancy and, on the
kernel backend, the B_X x B_A plane products of every MAC.

Usage: PYTHONPATH=src python -m repro_torch.roofline.analysis \\
           [--dryrun-dir artifacts/dryrun] [--mesh pod1]
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os

CARD = "H100 SXM 80GB"
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
PEAK_INT8_OPS = 1979e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
NODE_BW = 50e9
NODE_CARDS = 8


def axis_links(mesh_shape: dict) -> dict:
    """Each mesh axis's link: ``"nvlink"`` when its group's cards share
    a node, ``"network"`` when the group crosses nodes."""
    names = list(mesh_shape)
    out = {}
    for i, a in enumerate(names):
        stride = math.prod(mesh_shape[b] for b in names[i + 1:])
        span = stride * (mesh_shape[a] - 1)
        out[a] = "nvlink" if span < NODE_CARDS else "network"
    return out


def _advice(dom: str) -> str:
    if dom == "collective":
        return ("reduce cross-card traffic: shard heads and the 2-D "
                "training compute over the model axis, keep groups inside "
                "an NVLink node, overlap collectives with compute")
    if dom == "memory":
        return ("cut HBM traffic: fuse the glue around each projection "
                "into the kernel (int8 planes straight from quantize), "
                "keep weights in bf16/int8 planes, skip all-zero expert "
                "groups")
    return ("compute-bound (good): keep the dots on bf16 tensor cores, "
            "trim remat recompute and the plane products that add no "
            "useful work")


def load_cells(dryrun_dir: str, mesh: str | None = None):
    cells = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("tag"):
            continue     # perf-iteration variants are reported separately
        if mesh and rec.get("mesh") != mesh:
            continue
        cells.append(rec)
    return cells


def compute_s(hs: dict) -> float:
    """The compute term of a step's counts."""
    by_dtype = hs.get("dot_flops_by_dtype") or {"float32": hs["dot_flops"]}
    return (sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"])
                for dt, f in by_dtype.items())
            + hs.get("kernel_ops", 0) / PEAK_INT8_OPS)


def memory_s(hs: dict) -> float:
    return (hs.get("dot_bytes", hs["result_bytes"])
            + hs.get("kernel_bytes", 0)) / HBM_BW


def collective_s(hs: dict, mesh_shape: dict) -> tuple[float, str]:
    """The collective term and the links it uses ("" without any)."""
    links = axis_links(mesh_shape)
    t, used = 0.0, set()
    for axis, v in hs.get("collectives_by_axis", {}).items():
        link = links.get(axis, "network")
        t += v["bytes"] / (NVLINK_BW if link == "nvlink" else NODE_BW)
        if v["bytes"]:
            used.add(link)
    return t, "+".join(sorted(used))


def roofline_row(rec: dict) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.models.counting import model_flops, param_count

    if rec["status"] != "ok":
        return {**rec, "row": None}
    shape = SHAPES[rec["shape"]]
    cfg = get_config(rec["arch"])
    n_dev = rec["n_devices"]
    hs = rec["hlo_stats"]

    tokens = shape.batch * (shape.seq if shape.kind != "decode" else 1)
    mf_dev = model_flops(cfg, tokens, shape.kind) / n_dev
    work = hs["dot_flops"] + hs.get("kernel_ops", 0)

    t_c = compute_s(hs)
    t_m = memory_s(hs)
    t_x, link = collective_s(hs, rec.get("mesh_shape",
                                         {"data": 16, "model": 16}))
    dom = max((("compute", t_c), ("memory", t_m), ("collective", t_x)),
              key=lambda kv: kv[1])[0]
    bound = max(t_c, t_m, t_x)
    row = dict(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        compute_s=t_c, memory_s=t_m, collective_s=t_x, link=link or "—",
        dominant=dom,
        model_flops_dev=mf_dev,
        hlo_flops_dev=work,
        useful_ratio=(mf_dev / work) if work else 0.0,
        roofline_fraction=((mf_dev / PEAK_FLOPS["bfloat16"]) / bound
                           if bound else 0.0),
        params_total=param_count(cfg),
        params_active=param_count(cfg, active=True),
        temp_gib=rec.get("memory_analysis", {}).get(
            "temp_size_in_bytes", 0) / 2 ** 30,
        args_gib=rec.get("arg_bytes_per_device", 0) / 2 ** 30,
        advice=_advice(dom),
    )
    return {**rec, "row": row}


def fmt_table(rows, title: str) -> str:
    out = [f"### {title}", "",
           "| arch | shape | compute s | memory s | collective s | link | "
           "dominant | MODEL_FLOPs/dev | useful ratio | roofline frac | "
           "state GiB/dev | temp GiB/dev |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["row"] is None:
            why = r.get("reason") or r["status"]
            if r["status"] == "error":
                lines = r.get("error", "").strip().splitlines()
                why = "error: " + (lines[-1] if lines else "")
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                       f"{why[:120]} | — | — | — | — | — |")
            continue
        w = r["row"]
        out.append(
            f"| {w['arch']} | {w['shape']} | {w['compute_s']:.3e} | "
            f"{w['memory_s']:.3e} | {w['collective_s']:.3e} | {w['link']} | "
            f"**{w['dominant']}** | {w['model_flops_dev']:.3g} | "
            f"{w['useful_ratio']:.3g} | {w['roofline_fraction']:.3g} | "
            f"{w['args_gib']:.2f} | {w['temp_gib']:.2f} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="artifacts/dryrun")
    ap.add_argument("--mesh", default="pod1",
                    help="roofline table is single-pod per the assignment")
    ap.add_argument("--out", default="artifacts/roofline.md")
    args = ap.parse_args(argv)

    cells = load_cells(args.dryrun_dir, args.mesh)
    rows = [roofline_row(c) for c in cells]
    ok = [r for r in rows if r["row"]]
    n = 512 if args.mesh == "pod2" else 256
    backends = sorted({c.get("backend", "digital") for c in cells})
    text = fmt_table(rows, f"Roofline ({args.mesh}, {n} x {CARD} at 700 W "
                           f"data-sheet peaks; backend "
                           f"{', '.join(backends)})")
    text += "\n\nPer-cell advice on the dominant term:\n"
    for r in ok:
        w = r["row"]
        text += (f"- **{w['arch']} / {w['shape']}** [{w['dominant']}]: "
                 f"{w['advice']}\n")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
