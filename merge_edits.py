"""Times of edited copies of M1, the round merge's vote kernel
(racon_tpu_torch/csrc/merge.cu ``racon_merge_votes``), on one NVIDIA GPU.

    python3 merge_edits.py [--reps N]

Each edit of EDITS is made to merge.cu by text replacement; every
variant compiles at once (one nvcc each) under the build directory and
loads with ctypes. Each runs M1 on chip_smoke.py phase 7's inputs (phase
4's dataset, its first consensus chunk at round 0: [B, Lq, LA, n_win] =
[4096, 640, 640, 160]) at merge_votes_plan's launch, timed in turns with
the library's kernel (CUDA graphs of 10 calls, warm medians of ``reps``
replays: chip_smoke.time_graph_turns). The exact edits must keep the
library's bits:

- ``ahead 4``: walk entries in flight 4 jobs ahead instead of 6;
- ``byte depth 1``: query bytes in flight 1 job ahead instead of 2;
- ``plain stores``: the output's stores without the streaming hint.

The diagnostic edits change the sums and measure what a part of the
kernel costs:

- ``no run zeroing``: the run channels a gap never adds to are left
  unwritten;
- ``stores only``: no job loop, only the output's stores.

An edit whose text is no longer in merge.cu fails the run. Prints one
JSON line (each variant's ms and whether its sums equal the library's),
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import sys
import tempfile

from chip_smoke import (card, fail, main_dataset, merge_chunk, same_bits,
                        time_graph_turns)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "racon_tpu_torch", "csrc", "merge.cu")

# name -> (exact, [(old, new), ...]); an old text starting "re:" is a
# regular expression.
EDITS = {
    "ahead 4": (True, [("constexpr int kAhead = 6;",
                        "constexpr int kAhead = 4;")]),
    "byte depth 1": (True, [("constexpr int kByteDepth = 2;",
                             "constexpr int kByteDepth = 1;")]),
    "plain stores": (True, [(r"re:__stcs\(([^;]+?), ([^;]+)\);",
                             r"*(\1) = \2;")]),
    "no run zeroing": (False, [
        ("__stcs(out + (kPileW + zc + z) * LA1, 0.0f);", ";"),
        ("if (!tc.has(ch)) __stcs(out + (kPileW + ch) * LA1, 0.0f);",
         ";")]),
    "stores only": (False, [("for (int r0 = 0; r0 < n; r0 += kStage) {",
                             "for (int r0 = 0; r0 < 0; r0 += kStage) {")]),
}


def variant_source(src: str, name: str) -> str:
    for old, new in EDITS[name][1]:
        if old.startswith("re:"):
            src, n = re.subn(old[3:], new, src)
        else:
            n = src.count(old)
            src = src.replace(old, new)
        if n == 0:
            fail(f"edit {name!r}: its text is not in merge.cu")
    return src


def build_variants() -> dict:
    """One shared library for each edit, compiled at once; returns name
    -> ctypes library."""
    from racon_tpu_torch.native.build import build_dir, content_tag, run_build
    from racon_tpu_torch.ops import kernels
    with open(_SRC) as f:
        src = f.read()
    out = os.path.join(build_dir(), "merge_edits")
    os.makedirs(out, exist_ok=True)
    paths, cmds = {}, []
    for i, name in enumerate(EDITS):
        cu = os.path.join(out, f"merge_{i}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, name))
        tag = content_tag([cu], kernels.NVCC_FLAGS)
        paths[name] = os.path.join(out, f"libmerge_{i}.{tag}.so")
        if not os.path.isfile(paths[name]):
            cmds.append([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", cu,
                         "-o", paths[name]])
    run_build(cmds)
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        lib.racon_merge_votes.restype = ci
        lib.racon_merge_votes.argtypes = ([vp, ctypes.c_longlong] +
                                          [vp] * 11 + [ci] * 5 + [vp])
        libs[name] = lib
    return libs


def variant_fn(lib, name, c, mem, n_win, LA):
    """``(run, outputs)``: one launch of the edited M1 ``lib`` on the chunk
    ``c``, into the outputs it returns."""
    import torch
    from racon_tpu_torch.ops import kernels
    B, Lq = c["q"].shape
    dev = c["q"].device
    walk, row = kernels._walk_words(c["cols"], B, LA, dev)
    plan = kernels.merge_votes_plan(LA)
    votes = torch.empty((n_win, kernels.VOTE_CH, LA + 1),
                        dtype=torch.float32, device=dev)
    wesc = torch.empty((n_win,), dtype=torch.float32, device=dev)

    def run():
        rc = lib.racon_merge_votes(
            walk.data_ptr(), row, c["q"].data_ptr(), c["qw8"].data_ptr(),
            c["w_read"].data_ptr(), c["lt"].data_ptr(), c["t_off"].data_ptr(),
            c["esc_w"].data_ptr(), *(m.data_ptr() for m in mem),
            votes.data_ptr(), wesc.data_ptr(), n_win, Lq, LA, plan["gaps"],
            plan["threads"], torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"edit {name!r}: launch failed (cudaError {rc})")
    return run, (votes, wesc)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    from racon_tpu_torch.ops import device_merge as dm
    from racon_tpu_torch.ops import kernels
    name_limit = card()
    kernels.build()
    libs = build_variants()
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        c = merge_chunk("cuda", main_dataset(tmp)["paths"])
    n_win, LA = c["plan"].n_win, c["plan"].LA
    vargs = (c["cols"], c["q"], c["qw8"], c["w_read"], c["lt"], c["t_off"],
             c["esc_w"], c["win"])
    mem = dm.window_members(c["win"], n_win)
    ref = kernels.merge_votes(*vargs, mem, n_win=n_win, LA=LA)
    if not same_bits(dm.merge_votes_plain(*vargs, n_win=n_win, LA=LA), ref):
        fail("the library's merge_votes disagrees with its plain version")
    fns = {"library": lambda: kernels.merge_votes(*vargs, mem, n_win=n_win,
                                                  LA=LA)}
    rec = {"shape": [c["plan"].B, c["plan"].Lq, LA, n_win], "card": name_limit,
           "variants": {"library": {"exact": True, "bitwise": True}}}
    for name, lib in libs.items():
        run, outs = variant_fn(lib, name, c, mem, n_win, LA)
        run()
        exact, same = EDITS[name][0], same_bits(ref, outs)
        if exact and not same:
            fail(f"edit {name!r} changes M1's sums")
        rec["variants"][name] = {"exact": exact, "bitwise": same}
        fns[name] = run
    for name, ms in zip(fns, time_graph_turns(list(fns.values()),
                                              reps=opts.reps, calls=10)):
        rec["variants"][name]["ms"] = ms
    print(json.dumps(rec), flush=True)
    print(name_limit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
