"""Window: the unit of consensus — a backbone slice plus read layers.

Re-design of the reference's Window (src/window.{hpp,cpp}). The reference
holds raw (char*, len) pointers into Sequence storage and runs one SPOA
graph per window on a CPU thread (src/window.hpp:61-67, window.cpp:61-137).
Here a Window is a host-side descriptor holding zero-copy ``memoryview``
slices; consensus is computed for *batches* of windows at once by the JAX
engine (racon_tpu.ops.poa), with windows as the batch dimension.

Parity points:
- createWindow validates a non-empty backbone with equal-length quality
  (src/window.cpp:19-23).
- add_layer validates quality length and begin/end positions
  (src/window.cpp:42-59).
- Consensus of a window with fewer than 3 total sequences (backbone + 2
  layers) is the backbone itself, marked unpolished (src/window.cpp:63-66).
- Layers are processed sorted by window-relative begin (src/window.cpp:74-80).
- kTGS windows trim consensus ends with coverage < (n_seqs - 1) / 2
  (src/window.cpp:113-134); fully-trimmed windows warn about a chimeric
  contig and keep the untrimmed consensus.
"""

from __future__ import annotations

import enum
import sys
from typing import List, Optional

import numpy as np

from racon_tpu_torch.models.overlap import PolisherError


class WindowType(enum.Enum):
    NGS = 0  # mean read length <= 1000 (src/polisher.cpp:246-247)
    TGS = 1


class Window:
    __slots__ = (
        "id", "rank", "type",
        "backbone", "backbone_quality",
        "layer_data", "layer_quality", "layer_begin", "layer_end",
        "consensus", "polished",
    )

    def __init__(self, id_: int, rank: int, type_: WindowType,
                 backbone, backbone_quality) -> None:
        if len(backbone) == 0 or (backbone_quality is not None and
                                  len(backbone) != len(backbone_quality)):
            raise PolisherError(
                "[racon_tpu_torch::create_window] error: "
                "empty backbone sequence/unequal quality length!")
        self.id = id_
        self.rank = rank
        self.type = type_
        self.backbone = backbone
        self.backbone_quality = backbone_quality
        self.layer_data: List = []
        self.layer_quality: List[Optional[object]] = []
        self.layer_begin: List[int] = []
        self.layer_end: List[int] = []
        self.consensus: Optional[bytes] = None
        self.polished = False

    def __len__(self) -> int:
        return len(self.backbone)

    @property
    def n_layers(self) -> int:
        return len(self.layer_data)

    def add_layer(self, data, quality, begin: int, end: int) -> None:
        """Append a read segment layer (src/window.cpp:42-59).

        ``begin``/``end`` are window-relative target positions; ``end`` is
        the inclusive last matched backbone position (the reference passes
        last_match.t - window_start - 1, src/polisher.cpp:439-442).
        """
        if quality is not None and len(data) != len(quality):
            raise PolisherError(
                "[racon_tpu_torch::Window::add_layer] error: unequal quality size!")
        # begin < 0 also rejected: the reference's uint32_t coercion makes
        # negative positions enormous and they fail its bounds check.
        if begin < 0 or begin >= end or begin > len(self.backbone) or \
                end > len(self.backbone):
            raise PolisherError(
                "[racon_tpu_torch::Window::add_layer] error: "
                "layer begin and end positions are invalid!")
        self.layer_data.append(data)
        self.layer_quality.append(quality)
        self.layer_begin.append(begin)
        self.layer_end.append(end)

    def set_backbone_consensus(self) -> None:
        """Windows that cannot be polished keep their backbone
        (src/window.cpp:63-66)."""
        self.consensus = bytes(self.backbone)
        self.polished = False

    def apply_consensus(self, consensus: bytes, coverage: np.ndarray,
                        log=sys.stderr) -> None:
        """Install an engine-produced consensus, applying the kTGS coverage
        trim (src/window.cpp:113-134)."""
        if self.type == WindowType.TGS:
            average_coverage = (self.n_layers + 1 - 1) // 2  # (n_seqs-1)/2
            keep = np.flatnonzero(coverage[:len(consensus)] >= average_coverage)
            if len(keep) == 0 or keep[0] >= keep[-1]:
                print(
                    f"[racon_tpu_torch::Window::generate_consensus] warning: contig "
                    f"{self.id} might be chimeric in window {self.rank}!",
                    file=log)
            else:
                consensus = consensus[keep[0]:keep[-1] + 1]
        self.consensus = consensus
        self.polished = True


def sorted_layer_order(window: Window) -> np.ndarray:
    """Layer processing order: ascending window-relative begin
    (src/window.cpp:74-80). Stable to keep input order among ties."""
    return np.argsort(np.asarray(window.layer_begin, dtype=np.int64),
                      kind="stable")


def window_arrays(window: Window):
    """Encode one window for a consensus engine (host or device).

    Returns (layers, bb_codes, bb_weights): layers is a list of
    (codes uint8, weights float32, begin, end) in processing order;
    weights are Phred (quality - 33) or 1.0 without quality, the backbone
    carries its quality or zeros (the reference's dummy '!' quality,
    src/polisher.cpp:141).
    """
    from racon_tpu_torch.ops.encode import encode_bases
    layers = []
    for li in sorted_layer_order(window):
        data = bytes(window.layer_data[li])
        qual = window.layer_quality[li]
        codes = encode_bases(data)
        if qual is not None:
            wts = (np.frombuffer(bytes(qual), dtype=np.uint8)
                   .astype(np.float32) - 33.0)
        else:
            wts = np.ones(len(data), dtype=np.float32)
        layers.append((codes, wts, int(window.layer_begin[li]),
                       int(window.layer_end[li])))
    bb = encode_bases(bytes(window.backbone))
    if window.backbone_quality is not None:
        bw = (np.frombuffer(bytes(window.backbone_quality), dtype=np.uint8)
              .astype(np.float32) - 33.0)
    else:
        bw = np.zeros(len(bb), dtype=np.float32)
    return layers, bb, bw
