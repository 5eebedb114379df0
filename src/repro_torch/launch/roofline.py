"""Roofline analysis from dry-run records (the reference's
``repro.launch.roofline``), on H100 SXM5 80GB constants.

Terms per (arch × shape × mesh), all in seconds, per device:

  compute    = flops / 989.4e12 dense BF16 FLOP/s
  memory     = bytes_accessed / 3.35e12 B/s HBM3
  collective = sum over mesh axes of that axis's collective bytes over its
               link: ``model`` (one node's 8 GPUs) on NVLink 4 at 450e9 B/s
               per direction per GPU, ``data`` / ``pod`` (across nodes) on
               NDR InfiniBand at 50e9 B/s per GPU

A record without ``by_axis`` (one of the reference's, from XLA) puts all
its collective bytes on InfiniBand, the slower link: its HLO does not say
which axis each collective spans.

The port's dry run (:mod:`repro_torch.launch.dryrun`) runs every layer
eagerly, so its counts are already per trip: a record's ``flops`` and
``bytes_accessed`` are used as they are. The HLO text parser below is the
reference's, carried unchanged, so that ``--hlo-dir`` also reads the
reference's HLO dumps (``DRYRUN_HLO_DIR``): XLA's ``cost_analysis()``
counts a while-loop body once, and the parser re-derives FLOPs, bytes and
collective bytes from the optimized HLO, multiplying loop bodies by their
trip counts.

MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params — the
"useful compute" yardstick; the counted/MODEL ratio flags remat and
dispatch waste.
"""
from __future__ import annotations

import dataclasses
import gzip
import json
import re

# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM5 80GB column:
PEAK_FLOPS = 989.4e12  # dense BF16 Tensor Core FLOP/s (1,979 TFLOPS with sparsity)
HBM_BW = 3.35e12  # HBM3 bytes/s
NVLINK_BW = 450e9  # NVLink 4: 900 GB/s per GPU, 450 GB/s each direction
IB_BW = 50e9  # NDR InfiniBand, 400 Gb/s per GPU (one ConnectX-7 per GPU)
LINK_OF_AXIS = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}

DTYPE_BYTES = dict(
    f64=8, f32=4, bf16=2, f16=2, s64=8, u64=8, s32=4, u32=4, s16=2, u16=2,
    s8=1, u8=1, pred=1, c64=8, c128=16, u4=1, s4=1,
)

_SHAPE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_COMP_HDR = re.compile(r"^(?:ENTRY )?%?([\w\.\-]+)\s*\(.*\)\s*->")
_WHILE = re.compile(r"while\(.*\).*condition=%?([\w\.\-]+), body=%?([\w\.\-]+)")
# result may be a scalar shape or a tuple of shapes (all-to-all emits tuples)
_COLL = re.compile(
    r"=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\][^\s]*)\s*(all-gather|all-reduce|"
    r"reduce-scatter|all-to-all|collective-permute)\("
)


def collective_line_bytes(line: str):
    """(kind, bytes) if this HLO line applies a collective op, else None."""
    m = _COLL.search(line)
    if not m:
        return None
    total = sum(_bytes_of(dt, dims) for dt, dims in _SHAPE.findall(m.group(1)))
    return m.group(2), total
_CONST_CMP = re.compile(r"compare\(.*\)")
_CONSTANT = re.compile(r"constant\((\d+)\)")


def _bytes_of(dt: str, dims: str) -> float:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return DTYPE_BYTES.get(dt, 4) * n


def _elems(dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n


@dataclasses.dataclass
class CompCost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    whiles: list = dataclasses.field(default_factory=list)  # (cond, body)
    calls: list = dataclasses.field(default_factory=list)  # fusion/call targets


_CALLS = re.compile(r"(?:calls|to_apply|body)=%?([\w\.\-]+)")
_RESULT = re.compile(r"^%?[\w\.\-]+ = ([a-z0-9]+)\[([0-9,]*)\]")


_DEF = re.compile(r"^%?([\w\.\-]+) = ")
_DOT_OPS = re.compile(r"dot\(%?([\w\.\-]+), %?([\w\.\-]+)\)")
_LHS_CDIMS = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")


def parse_hlo(text: str):
    """Split into computations and cost each one (dots, collectives, whiles).

    HLO operands are variable references, so each computation carries a
    symbol table (instruction → shape) used to resolve dot operand shapes.
    """
    comps: dict[str, CompCost] = {}
    consts: dict[str, int] = {}  # computation -> max int constant (trip bound)
    cur = None
    symtab: dict[str, tuple] = {}
    pending_dots: list[tuple] = []

    def close_comp():
        if cur is None:
            return
        cc = comps[cur]
        for out_dt, out_dims, lhs, rhs, cdims in pending_dots:
            lshape = symtab.get(lhs)
            rshape = symtab.get(rhs)
            if lshape is None:
                continue
            lhs_dims = [int(d) for d in lshape[1].split(",") if d]
            k = 1.0
            if cdims is not None and lhs_dims:
                for i in cdims.split(","):
                    if i:
                        k *= lhs_dims[int(i)]
            elif lhs_dims:
                k = float(lhs_dims[-1])
            cc.flops += 2.0 * _elems(out_dims) * k
            cc.bytes += _bytes_of(out_dt, out_dims) + _bytes_of(*lshape)
            if rshape is not None:
                cc.bytes += _bytes_of(*rshape)

    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.endswith("{"):
            m = _COMP_HDR.match(line.rstrip("{").strip())
            if m:
                close_comp()
                cur = m.group(1)
                comps[cur] = CompCost()
                consts[cur] = 0
                symtab = {}
                pending_dots = []
                continue
        if cur is None or line == "}":
            if line == "}":
                close_comp()
                cur = None
            continue
        cc = comps[cur]
        md = _DEF.match(line)
        if md:
            ms = _SHAPE.search(line[md.end() - 2 :])
            if ms:
                symtab[md.group(1)] = (ms.group(1), ms.group(2))
        for m in _CONSTANT.finditer(line):
            consts[cur] = max(consts[cur], int(m.group(1)))
        mw = _WHILE.search(line)
        if mw:
            cc.whiles.append((mw.group(1), mw.group(2)))
            continue
        mc = collective_line_bytes(line)
        if mc:
            k, b = mc
            cc.coll_bytes += b
            cc.coll_by_kind[k] = cc.coll_by_kind.get(k, 0.0) + b
            continue
        if " fusion(" in line or " call(" in line or " conditional(" in line:
            for tgt in _CALLS.findall(line):
                cc.calls.append(tgt)
            continue
        if " dot(" in line:
            mr = _RESULT.match(line)
            mo = _DOT_OPS.search(line)
            if not (mr and mo):
                continue
            mk = _LHS_CDIMS.search(line)
            pending_dots.append(
                (
                    mr.group(1), mr.group(2), mo.group(1), mo.group(2),
                    mk.group(1) if mk else None,
                )
            )
    close_comp()
    return comps, consts


def total_cost(text: str) -> dict:
    comps, consts = parse_hlo(text)

    memo: dict[str, tuple] = {}

    def cost_of(name: str, depth=0) -> tuple:
        if name in memo:
            return memo[name]
        if name not in comps or depth > 12:
            return (0.0, 0.0, 0.0, {})
        cc = comps[name]
        f, b, c = cc.flops, cc.bytes, cc.coll_bytes
        kinds = dict(cc.coll_by_kind)
        for tgt in cc.calls:  # fusions / calls execute once per reference
            tf, tb, tc, tk = cost_of(tgt, depth + 1)
            f += tf
            b += tb
            c += tc
            for k, v in tk.items():
                kinds[k] = kinds.get(k, 0.0) + v
        for cond, body in cc.whiles:
            trips = max(1, consts.get(cond, 1))
            bf, bb, bc, bk = cost_of(body, depth + 1)
            f += bf * trips
            b += bb * trips
            c += bc * trips
            for k, v in bk.items():
                kinds[k] = kinds.get(k, 0.0) + v * trips
        memo[name] = (f, b, c, kinds)
        return memo[name]

    # entry = the computation containing whiles at top level; XLA text marks
    # it with ENTRY; find it as the computation whose name contains 'main'
    entry = None
    for name in comps:
        if "main" in name:
            entry = name
            break
    if entry is None:  # fallback: computation with most flops after expansion
        entry = max(comps, key=lambda n: cost_of(n)[0])
    f, b, c, kinds = cost_of(entry)
    return dict(flops=f, bytes=b, coll_bytes=c, coll_by_kind=kinds, entry=entry)


def collective_time(rec: dict) -> float:
    """Seconds of collectives per device: each mesh axis's bytes over its
    link; a group over several axes (``"data+model"``) or an unknown one
    goes at the slowest link among them, and a record without
    ``by_axis`` entirely on InfiniBand."""
    coll = rec.get("collectives", {})
    by_axis = coll.get("by_axis")
    if by_axis is None:
        return coll.get("total", 0) / IB_BW
    t = 0.0
    for axes, size in by_axis.items():
        bw = min(LINK_OF_AXIS.get(a, IB_BW) for a in axes.split("+"))
        t += size / bw
    return t


def analyze_cell(rec: dict, hlo_path: str | None = None) -> dict:
    """Compute roofline terms for one dry-run record (+ optional HLO file)."""
    chips = rec.get("chips", 256)
    coll = rec.get("collectives", {})
    if hlo_path:
        with gzip.open(hlo_path, "rt") as f:
            text = f.read()
        cost = total_cost(text)
        flops_dev = cost["flops"]
        bytes_dev = max(cost["bytes"], rec.get("bytes_accessed", 0))
        coll_dev = cost["coll_bytes"]
        coll_kinds = cost["coll_by_kind"]
        t_coll = coll_dev / IB_BW
    else:
        flops_dev = rec.get("flops", 0)
        bytes_dev = rec.get("bytes_accessed", 0)
        coll_dev = coll.get("total", 0)
        coll_kinds = coll.get("bytes", {})
        t_coll = collective_time(rec)
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    terms = dict(compute=t_compute, memory=t_memory, collective=t_coll)
    bottleneck = max(terms, key=terms.get)
    out = dict(
        rec,
        flops_per_dev=flops_dev,
        bytes_per_dev=bytes_dev,
        coll_bytes_per_dev=coll_dev,
        coll_by_kind=coll_kinds,
        t_compute=t_compute,
        t_memory=t_memory,
        t_collective=t_coll,
        bottleneck=bottleneck,
    )
    # MODEL_FLOPS yardstick
    n_act = rec.get("active_params")
    if n_act and rec.get("status") == "ok":
        model_flops = model_flops_of(rec, n_act)
        out["model_flops"] = model_flops
        hlo_total = flops_dev * chips
        out["useful_ratio"] = model_flops / hlo_total if hlo_total else 0.0
        out["roofline_frac"] = (
            (model_flops / (chips * PEAK_FLOPS)) / max(terms.values())
            if max(terms.values()) > 0
            else 0.0
        )
    return out


def model_flops_of(rec: dict, n_act: float) -> float:
    """6·N·D for a train record, 2·N·D for prefill, 2·N per sequence for
    decode; D from the record's ``tokens`` (batch × seq) when it has one,
    else from its shape's :data:`SHAPES` entry."""
    from repro_torch.launch.shapes import SHAPES

    if "tokens" in rec:
        tokens = rec["tokens"]
    else:
        info = SHAPES[rec["shape"]]
        tokens = info["batch"] * (info["seq"] if rec.get("kind") != "decode" else 1)
    return {"train": 6.0, "prefill": 2.0}.get(rec.get("kind"), 2.0) * n_act * tokens


def main(argv=None):
    import argparse
    import os

    ap = argparse.ArgumentParser(description="Roofline terms of dry-run records.")
    ap.add_argument("results", help="dryrun results.jsonl")
    ap.add_argument("--hlo-dir", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = []
    with open(args.results) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("status") != "ok":
                rows.append(rec)
                continue
            hlo = None
            if args.hlo_dir:
                p = os.path.join(
                    args.hlo_dir,
                    f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.hlo.gz",
                )
                hlo = p if os.path.exists(p) else None
            rows.append(analyze_cell(rec, hlo))
    text = json.dumps(rows, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(table_header())
    for r in rows:
        print(table_row(r))


def table_header() -> str:
    return (f"{'arch':22s} {'shape':12s} {'mesh':8s} {'compute':>9s} {'memory':>9s} "
            f"{'collect':>9s} {'bneck':>10s} {'useful':>7s} {'roofl%':>7s}")


def table_row(r: dict) -> str:
    if r.get("status") != "ok":
        return (f"{r.get('arch','?'):22s} {r.get('shape','?'):12s} {r.get('mesh','?'):8s} "
                f"-- {r.get('status')}: {r.get('reason', r.get('error',''))[:60]}")
    return (
        f"{r['arch']:22s} {r['shape']:12s} {r['mesh']:8s} "
        f"{r['t_compute']*1e3:8.2f}m {r['t_memory']*1e3:8.2f}m "
        f"{r['t_collective']*1e3:8.2f}m {r['bottleneck']:>10s} "
        f"{r.get('useful_ratio', 0):7.2f} {100*r.get('roofline_frac', 0):6.1f}%"
    )


if __name__ == "__main__":
    main()
