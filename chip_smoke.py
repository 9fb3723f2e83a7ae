"""Chip smoke of the PyTorch/CUDA port (racon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line with the card's name and power limit;
any failure exits non-zero and prints no result):

1. build      the CUDA kernels (csrc/*.cu, one nvcc per source, started
              together) and the host C++ aligner, from this checkout;
2. kernels    each kernel against its plain PyTorch version on the card,
              bitwise, at the main path's shapes; kernel and plain times
              from CUDA events;
3. small      the CLI on a ~20 kb synthetic input with --device cuda and
              --device cpu: the FASTA must be byte-identical;
4. main       the main path at full size through the CLI entry point: a
              1 Mbp synthetic draft (20 contigs x 50 kb), 10 kb reads at
              30x, PAF overlaps aligned on the host, w=500. Launch counts
              reset just before and read just after; band_fwd must have
              launched. Polished edit distance to the truth must be at
              most a third of the draft's;
5. flat path  the band-off route (RACON_TPU_NO_BAND=1, the full-width
              forward) through the CLI on a 100 kb input, with its own
              launch counts; flat_fwd must have launched.

The line before the last holds the kernel records, the line before it
the card's name and power limit, the last line the ok record.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM rates used for the bounds: HBM 3.35 TB/s; int32
# 16.7 TOP/s = 132 SMs x 64 INT32 lanes x 1.98 GHz (the 67 TFLOP/s fp32
# figure counts 128 lanes and an FMA as two operations).
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9
# Integer operations per DP cell, counted from the kernel sources.
OPS_PER_CELL = {("band_fwd", 4): 50, ("band_fwd", 2): 40,
                ("band_fwd", 1): 30, ("flat_fwd", 0): 25}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, "card": CARD, **kw}), flush=True)


def time_ms(fn, reps: int = 5) -> float:
    """Warm median of ``reps`` timed calls (CUDA events)."""
    import torch
    fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def max_abs_err(ref, out) -> int:
    import torch
    err = 0
    for r, o in zip(ref, out):
        if r is None or o is None:
            if (r is None) != (o is None):
                return 1 << 30
            continue
        if r.dtype == torch.uint16:
            r, o = r.view(torch.int16), o.view(torch.int16)
        if r.dtype in (torch.int16, torch.uint8):
            r = r.to(torch.int32) & (0xFFFF if r.dtype == torch.int16
                                     else 0xFF)
            o = o.to(torch.int32) & (0xFFFF if o.dtype == torch.int16
                                     else 0xFF)
        d = (r.to(torch.int64) - o.to(torch.int64)).abs().max().item()
        err = max(err, int(d))
    return err


def band_inputs(device, B, Lq, W, seed=1):
    """Main-path-like band inputs: query lengths ~ w=500 windows, target
    slices within the band, tband filled with 7 outside the slice."""
    import torch
    from racon_tpu_torch.ops.band import band_geometry
    rng = np.random.default_rng(seed)
    lq = rng.integers(Lq * 3 // 4, Lq - 8, B).astype(np.int32)
    lt = (lq + rng.integers(-40, 41, B)).astype(np.int32)
    klo, _ = band_geometry(torch.from_numpy(lq), torch.from_numpy(lt), W)
    y = np.arange(W + Lq)[None, :]
    rel = klo.numpy()[:, None] + y
    tband = rng.integers(0, 4, (B, W + Lq)).astype(np.uint8)
    tband[(rel < 0) | (rel >= lt[:, None])] = 7
    qT = rng.integers(0, 4, (Lq, B)).astype(np.uint8)
    return (torch.from_numpy(tband).to(device), torch.from_numpy(qT).to(device),
            klo.to(device), torch.from_numpy(lq).to(device))


def phase_kernels(device, B=4096, Lq=640, W=256, Bf=1024, Lt=640,
                  timed=True):
    """Each kernel against its plain version on the card, bitwise."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.band import fw_dirs_band_plain
    from racon_tpu_torch.ops.flat import fw_dirs_flat_plain
    sc = dict(match=5, mismatch=-4, gap=-8)
    recs = {}
    args = band_inputs(device, B, Lq, W)
    for k in (4, 2):
        def run_k():
            return kernels.fw_dirs_band(*args, W=W, nxt_k=k, **sc)

        def run_p():
            return fw_dirs_band_plain(*args, W=W, nxt_k=k, **sc)
        out = run_k()
        ref = run_p()
        err = max_abs_err(ref, out)
        del out, ref
        ms = time_ms(run_k) if timed else None
        plain_ms = time_ms(run_p, reps=1) if timed else None
        cells = B * Lq * W
        nbytes = (B * (W + Lq) + Lq * B + 8 * B +
                  cells * (1 + (1 if k >= 2 else 0) + (2 if k >= 4 else 0))
                  + 4 * B * W)
        b_ms = nbytes / HBM_BYTES_S * 1e3
        o_ms = cells * OPS_PER_CELL[("band_fwd", k)] / INT32_OPS_S * 1e3
        recs[("band_fwd", k)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(b_ms, o_ms),
            bound_by="bytes" if b_ms >= o_ms else "operations",
            shape=[B, Lq, W], nxt_k=k)
        emit("kernels", kernel="band_fwd", nxt_k=k, shape=[B, Lq, W],
             **{kk: v for kk, v in recs[("band_fwd", k)].items()
                if kk not in ("shape", "nxt_k")})
        if err:
            fail(f"band_fwd k={k} disagrees with its plain version "
                 f"(max_abs_err={err})")
    del args
    rng = np.random.default_rng(2)
    tbuf = torch.from_numpy(rng.integers(0, 4, (Bf, Lt)).astype(
        np.uint8)).to(device)
    qT = torch.from_numpy(rng.integers(0, 4, (Lq, Bf)).astype(
        np.uint8)).to(device)

    def run_fk():
        return kernels.fw_dirs_flat(tbuf, qT, **sc)

    def run_fp():
        return fw_dirs_flat_plain(tbuf, qT, **sc)
    err = max_abs_err([run_fp()], [run_fk()])
    ms = time_ms(run_fk) if timed else None
    plain_ms = time_ms(run_fp, reps=1) if timed else None
    cells = Bf * Lq * Lt
    b_ms = (Bf * Lt + Lq * Bf + cells) / HBM_BYTES_S * 1e3
    o_ms = cells * OPS_PER_CELL[("flat_fwd", 0)] / INT32_OPS_S * 1e3
    recs[("flat_fwd", 0)] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(b_ms, o_ms),
        bound_by="bytes" if b_ms >= o_ms else "operations",
        shape=[Bf, Lq, Lt], nxt_k=0)
    emit("kernels", kernel="flat_fwd", shape=[Bf, Lq, Lt], max_abs_err=err,
         ms=ms, plain_ms=plain_ms, bound_ms=max(b_ms, o_ms),
         bound_by=recs[("flat_fwd", 0)]["bound_by"])
    if err:
        fail(f"flat_fwd disagrees with its plain version (max_abs_err={err})")
    return recs


def run_cli(argv):
    """racon_tpu_torch.cli.main in this process; returns (rc, stdout
    bytes, stderr text, wall seconds)."""
    from racon_tpu_torch import cli
    out_b = io.BytesIO()
    out_t = io.TextIOWrapper(out_b, encoding="utf-8")
    err_t = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out_t), contextlib.redirect_stderr(err_t):
        rc = cli.main(argv)
        out_t.flush()
    return rc, out_b.getvalue(), err_t.getvalue(), time.perf_counter() - t0


def fasta_records(blob: bytes):
    lines = blob.split(b"\n")
    return {lines[i][1:].split(b" ")[0].decode(): lines[i + 1]
            for i in range(0, len(lines) - 1, 2)}


def phase_small(device, tmp):
    from racon_tpu_torch.utils.synth import write_dataset
    ds = write_dataset(os.path.join(tmp, "small"), seed=5, contig_len=20000,
                       read_len=5000, coverage=20)
    p = ds["paths"]
    argv = [p["reads"], p["overlaps"], p["draft"], "-t", "8"]
    rc_g, out_g, err_g, wall_g = run_cli(argv + ["--device", device])
    rc_c, out_c, err_c, wall_c = run_cli(argv + ["--device", "cpu"])
    if rc_g or rc_c:
        fail(f"small CLI run failed: {err_g[-2000:]} {err_c[-2000:]}")
    same = out_g == out_c and len(out_g) > 0
    emit("small", bytes=len(out_g), identical=same, wall_s_gpu=wall_g,
         wall_s_cpu=wall_c)
    if not same:
        fail("small run: --device cuda and --device cpu FASTA differ")


def consensus_seconds(err: str) -> float:
    m = re.findall(r"generated consensus ([0-9.]+) s", err)
    return float(m[-1]) if m else float("nan")


def routed(err: str):
    flagged = sum(int(x) for x in re.findall(
        r"(\d+) window\(s\) flagged", err))
    host = sum(int(x) for x in re.findall(
        r"(\d+) window\(s\) unresolved", err))
    return flagged, host


def phase_main(device, tmp, n_contigs=20, contig_len=50000,
               read_len=10000, coverage=30):
    import torch
    from racon_tpu_torch.ops import device_poa, kernels
    from racon_tpu_torch.utils.synth import edit_distance, write_dataset
    t0 = time.perf_counter()
    ds = write_dataset(os.path.join(tmp, "main"), seed=7,
                       n_contigs=n_contigs, contig_len=contig_len,
                       read_len=read_len, coverage=coverage,
                       draft_err=0.03, read_err=0.08)
    synth_s = time.perf_counter() - t0
    p = ds["paths"]
    n_windows = sum(-(-len(d) // 500) for d in ds["drafts"])
    argv = [p["reads"], p["overlaps"], p["draft"], "-t",
            str(os.cpu_count() or 1), "--device", device]
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    clock = device_poa.set_stage_clock(True)
    kernels.reset_launches()
    rc, out, err, wall = run_cli(argv)
    launches = dict(kernels.LAUNCHES)
    stages = clock.ms()
    device_poa.set_stage_clock(False)
    if rc:
        fail(f"main run failed: {err[-3000:]}")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    recs = fasta_records(out)
    ed_draft = ed_pol = 0
    for c, (t, d) in enumerate(zip(ds["truth"], ds["drafts"])):
        pol = recs.get(f"ctg{c}")
        if pol is None or len(pol) == 0:
            fail(f"main run: contig ctg{c} missing from the output")
        ed_draft += edit_distance(d, t)
        ed_pol += edit_distance(pol, t)
    cons_s = consensus_seconds(err)
    flagged, host = routed(err)
    emit("main", draft_bp=sum(len(d) for d in ds["drafts"]),
         windows=n_windows, synth_s=synth_s, wall_s=wall,
         consensus_s=cons_s, windows_per_s=n_windows / cons_s,
         windows_per_s_end_to_end=n_windows / wall, stage_ms=stages,
         max_memory_allocated=peak, launches=launches,
         redo_windows=flagged, host_windows=host,
         ed_draft=ed_draft, ed_polished=ed_pol)
    if launches["band_fwd"] <= 0:
        fail("main run: band_fwd never launched")
    if not ed_pol * 3 <= ed_draft:
        fail(f"main run: polished ED {ed_pol} > draft ED {ed_draft} / 3")
    return launches


def phase_flat(device, tmp, contig_len=100000):
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.utils.synth import write_dataset
    ds = write_dataset(os.path.join(tmp, "flat"), seed=9,
                       contig_len=contig_len, read_len=10000, coverage=30,
                       draft_err=0.03)
    p = ds["paths"]
    os.environ["RACON_TPU_NO_BAND"] = "1"
    try:
        kernels.reset_launches()
        rc, out, err, wall = run_cli([p["reads"], p["overlaps"], p["draft"],
                                      "-t", str(os.cpu_count() or 1),
                                      "--device", device])
        launches = dict(kernels.LAUNCHES)
    finally:
        del os.environ["RACON_TPU_NO_BAND"]
    if rc or not out:
        fail(f"flat-path run failed: {err[-3000:]}")
    emit("flat_path", wall_s=wall, consensus_s=consensus_seconds(err),
         launches=launches)
    if launches["flat_fwd"] <= 0:
        fail("flat-path run: flat_fwd never launched")
    return launches


def main() -> int:
    global CARD
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    try:
        from racon_tpu_torch.native.build import shared_library_path
        from racon_tpu_torch.ops import kernels
    except ImportError as exc:
        fail(f"racon_tpu_torch is not importable here ({exc})")
    CARD = card()
    t0 = time.perf_counter()
    kernels.build()
    shared_library_path()
    emit("build", seconds=time.perf_counter() - t0)

    recs = phase_kernels("cuda")
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        phase_small("cuda", tmp)
        main_launches = phase_main("cuda", tmp)
        flat_launches = phase_flat("cuda", tmp)

    rows = []
    for (name, k), r in recs.items():
        if name == "band_fwd" and k != 4:
            continue
        rows.append({
            "name": name, "route": "cuda",
            "source": f"racon_tpu_torch/csrc/{name}.cu",
            "replaces": ("racon_tpu/ops/pallas/band_kernel.py:96"
                         if name == "band_fwd" else
                         "racon_tpu/ops/pallas/flat_kernel.py:31"),
            "launches": (main_launches if name == "band_fwd"
                         else flat_launches)[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


CARD = ""

if __name__ == "__main__":
    sys.exit(main())
