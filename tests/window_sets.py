"""Synthetic window sets shared by the streaming-pipeline tests
(test_torch_pipeline.py, test_torch_walk_async.py): the reference's
tests/test_pipeline.py ``_build_windows``, for either package's Window."""

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)


def mutate(rng, truth):
    """A noisy copy: 4% deletions, 4% substitutions, 4% insertions."""
    out = []
    for b in truth:
        r = rng.random()
        if r < 0.04:
            continue
        out.append(int(BASES[rng.integers(0, 4)]) if r < 0.08 else int(b))
        if r > 0.96:
            out.append(int(BASES[rng.integers(0, 4)]))
    return bytes(out)


def build_windows(Window, WindowType, n, seed=0, coverage=5, wlen=80):
    """``n`` windows of ``coverage`` noisy layers over noisy backbones,
    every ninth window trivial (no layers); same seed, same windows."""
    rng = np.random.default_rng(seed)
    ws = []
    for i in range(n):
        truth = BASES[rng.integers(0, 4, wlen)]
        backbone = mutate(rng, truth)
        qual = bytes(rng.integers(43, 63, len(backbone), dtype=np.uint8))
        w = Window(i, i % 7, WindowType.TGS, backbone, qual)
        cov = 0 if i % 9 == 8 else coverage
        for _ in range(cov):
            lay = mutate(rng, truth)
            lq = bytes(rng.integers(43, 63, len(lay), dtype=np.uint8))
            w.add_layer(lay, lq, 0, len(backbone) - 1)
        ws.append(w)
    return ws


def port_windows(n, seed, wlen=80):
    from racon_tpu_torch.models.window import Window, WindowType
    return build_windows(Window, WindowType, n, seed, wlen=wlen)


def reference_windows(n, seed, wlen=80):
    from racon_tpu.models.window import Window, WindowType
    return build_windows(Window, WindowType, n, seed, wlen=wlen)
