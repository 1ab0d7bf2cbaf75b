"""H100 roofline terms from the dry run's records (``launch/dryrun.py``),
in place of the reference's TPU roofline:

    compute term    = flops / (chips * peak flop/s)
    memory term     = bytes / (chips * HBM bytes/s)
    collective term = collective bytes / (chips * link bytes/s)

flops and bytes are the dry run's counts per device (its ``delta_total``
where present, which equals the direct count), on a mesh rank 0's; the
collective bytes are its wire bytes per device, 0 on one card (the
global counts are rank 0's times the ranks: on a mesh of uneven blocks
an upper bound). The
default ceilings are the H100 SXM5 80GB data sheet's: 989 TFLOP/s dense
bf16 on the tensor cores (the compute term's one peak: every cell
computes in bf16; fp32 outside the tensor cores is 67 TFLOP/s), 3.35
TB/s of HBM3, 450 GB/s of NVLink a direction. They are not
measurements: ``cell_roofline`` takes other compute and memory ceilings
as arguments, so a card's own measured rates (``chip_smoke.py`` phase
19) can take their place.

The collective term charges every wire byte at NVLink's one rate, as
the reference charges its one ICI rate, so on the production meshes it
is a lower bound: a 16-rank model axis spans two 8-GPU NVLink nodes and
the data axes span many nodes, between which a GPU's rate is its
InfiniBand link's, about 50 GB/s on a DGX H100. A row keeps the record's
wire bytes by mesh axis (``collective_bytes_by_axis``), so a reader can
price each axis at its own rate.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

#: H100 SXM5 80GB data sheet: dense bf16 (the tensor cores, which run the
#: models' products), HBM3, and NVLink 4 a direction (900 GB/s both ways)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9


def model_flops(cfg, shape_kind: str, tokens: int) -> float:
    """6*N_active*D for training, 2*N_active*D for inference."""
    from repro_torch.configs.shapes import active_params
    n = active_params(cfg)
    mult = 6 if shape_kind == "train" else 2
    return mult * n * tokens


def cell_roofline(rec: dict, peak_flops: float = PEAK_FLOPS,
                  hbm_bw: float = HBM_BW) -> Optional[dict]:
    """The three terms (seconds) of one dry-run record at the given
    ceilings; None for a skipped or failed cell."""
    if rec.get("skipped") or "error" in rec:
        return None
    chips = rec["n_devices"]
    src = rec.get("delta_total") or rec["production"]
    flops_dev = src.get("flops", rec["production"]["flops"])
    bytes_dev = src.get("bytes_accessed", rec["production"]["bytes_accessed"])
    coll_dev = src.get("collective_wire_bytes_per_device")
    if coll_dev is None:
        coll_dev = rec["production"].get("collectives", {}).get(
            "total_wire_bytes_per_device", 0.0)
    t_compute = flops_dev / peak_flops          # per-device program seconds
    t_memory = bytes_dev / hbm_bw
    t_collective = coll_dev / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_collective}
    dom = max(terms, key=terms.get)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "chips": chips,
        "flops_global": flops_dev * chips,
        "bytes_global": bytes_dev * chips,
        "collective_bytes_global": coll_dev * chips,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_collective, "dominant": dom,
        "bound_time_s": max(terms.values()),
        "memory_fit": rec["production"]["memory"],
        "fits": rec.get("fits"),
        "collective_bytes_by_axis": rec["production"].get(
            "collectives", {}).get("wire_bytes_by_axis", {}),
    }


def load_all(directory: str) -> List[dict]:
    out = []
    for name in sorted(os.listdir(directory)):
        if name.endswith(".json"):
            with open(os.path.join(directory, name)) as f:
                out.append(json.load(f))
    return out


def roofline_table(directory: str, mesh: str = "card") -> List[dict]:
    """Every cell of ``mesh`` (``"card"``, ``"16x16"`` or ``"2x16x16"``)
    in ``directory`` with its terms, its model flops, the useful share of
    the counted flops, and the roofline fraction: model flops over the
    bound time against the peak."""
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES
    rows = []
    for rec in load_all(directory):
        if rec.get("mesh") != mesh or rec.get("overrides"):
            continue
        r = cell_roofline(rec)
        if r is None:
            rows.append({"arch": rec.get("arch"), "shape": rec.get("shape"),
                         "skipped": True,
                         "reason": rec.get("reason", rec.get("error",
                                                             ""))[:120]})
            continue
        cfg = configs.get(rec["arch"])
        sh = SHAPES[rec["shape"]]
        tokens = sh.global_batch * (sh.seq_len if sh.kind != "decode" else 1)
        mf = model_flops(cfg, sh.kind, tokens)
        r["model_flops"] = mf
        r["useful_ratio"] = mf / max(r["flops_global"], 1.0)
        # roofline fraction: useful model flops per bound-time vs peak
        r["roofline_fraction"] = (mf / r["bound_time_s"]) / (
            r["chips"] * PEAK_FLOPS)
        rows.append(r)
    return rows


_SHORT = {"all-gather": "AG", "reduce-scatter": "RS", "all-reduce": "AR",
          "all-to-all": "A2A", "collective-permute": "CP"}


def mesh_rows(directory: str, meshes=("16x16", "2x16x16"),
              overrides=None) -> List[str]:
    """A markdown row for each (arch, shape) of the mesh records in
    ``directory`` written with ``overrides`` (``--set``; default none):
    for each mesh, rank 0's peak (GB) and fit, its wire bytes a device by
    kind (GB), and the bound (ms) at the data sheet's rates with its
    dominant term."""
    cells = {}
    for rec in load_all(directory):
        if rec.get("mesh") in meshes and \
                (rec.get("overrides") or {}) == (overrides or {}):
            cells.setdefault((rec["arch"], rec["shape"]), {})[
                rec["mesh"]] = rec
    rows = []
    for (arch, shape), by_mesh in sorted(cells.items()):
        parts = [arch, shape]
        for m in meshes:
            rec = by_mesh.get(m)
            r = cell_roofline(rec) if rec else None
            if r is None:
                parts.append((rec or {}).get("reason", (rec or {}).get(
                    "error", "—"))[:40] or "—")
                continue
            wire = rec["production"]["collectives"]["wire_bytes_per_device"]
            parts.append(
                f"{rec['production']['memory']['peak_bytes'] / 1e9:.2f}"
                f"{'' if rec['fits'] else ' (no fit)'}; "
                + " ".join(f"{_SHORT[k]} {v / 1e9:.3g}"
                           for k, v in sorted(wire.items()))
                + f"; {r['bound_time_s'] * 1e3:.4g} ({r['dominant']})")
        rows.append("| " + " | ".join(parts) + " |")
    return rows
