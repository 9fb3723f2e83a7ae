"""The port's ingest plane (racon_tpu_torch/io/ingest.py, io/inflate.py,
the prefetcher in pipeline/streaming.py) against its classic parsers and
the JAX package's ingest plane.

- the inflate plans (BGZF, multi-member, single-member stream, empty):
  plan selection and bytes against ``gzip.open``;
- the readers: records of every plan and gate against the serial parsers
  and the reference's, chunk boundaries of the mmap readers, the
  zero-copy contract;
- errors: a torn multi-member file, a large torn file, a FASTQ quality
  mismatch and an EOF inside a FASTQ record name the same record and
  offset as the reference;
- the prefetcher: the serial chunks, a parse error re-raised, a safe
  close midstream;
- the CLI with RACON_TPU_INGEST=0 and =1, plain and gzipped inputs,
  against the reference CLI's bytes, with the ingest counters.
"""

import contextlib
import gzip
import io
import struct
import zlib

import numpy as np
import pytest

from racon_tpu_torch.io import ingest
from racon_tpu_torch.io.inflate import bgzf_block_size, open_gzip_source
from racon_tpu_torch.io.ingest import (IndexedFastaParser, IndexedFastqParser,
                                       materialized_copies, prefetch_ok,
                                       reset_materialized)
from racon_tpu_torch.io.parsers import (CHUNK_SIZE, FastaParser, FastqParser,
                                        ParseError, create_sequence_parser)
from racon_tpu_torch.pipeline import metrics
from racon_tpu_torch.pipeline.streaming import IngestPrefetcher, serial_chunks
from racon_tpu_torch.utils import env

T = 10.0


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(env.INGEST, raising=False)
    monkeypatch.delenv(env.INGEST_WORKERS, raising=False)
    monkeypatch.delenv(env.PIPELINE, raising=False)
    reset_materialized()
    metrics.reset()


def _bgzf_block(payload: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = co.compress(payload) + co.flush()
    bsize = len(cdata) + 26            # 12 hdr + 6 extra + 8 footer
    return (b"\x1f\x8b\x08\x04" + b"\x00" * 6 + struct.pack("<H", 6)
            + b"BC" + struct.pack("<HH", 2, bsize - 1) + cdata
            + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                          len(payload)))


def _write_bgzf(path, payload, block=4096):
    with open(path, "wb") as fh:
        for i in range(0, len(payload), block):
            fh.write(_bgzf_block(payload[i:i + block]))
        fh.write(_bgzf_block(b""))     # BGZF EOF marker


def _write_members(path, payload, n=6):
    step = max(len(payload) // n, 1)
    with open(path, "wb") as fh:
        for i in range(0, len(payload), step):
            fh.write(gzip.compress(payload[i:i + step]))


FA_PAYLOAD = b"".join(
    b">r%d desc %d\nACGTTGCA%d\nGGGGCC\n" % (i, i, i) for i in range(400))
FQ_PAYLOAD = b"".join(
    b"@q%d\nACGTACGTAC\n+\nIIIIJJJJKK\n" % i for i in range(400))


def _all(parser):
    """Every record of ``parser``, from its start."""
    parser.reset()
    return parser.parse(-1)[0]


def _recs(parser):
    return [(s.name, bytes(s.data),
             None if s.quality is None else bytes(s.quality))
            for s in _all(parser)]


def _ref_error(cls_name, path):
    """The reference parser's ParseError on ``path``."""
    from racon_tpu.io import ingest as r_ingest
    from racon_tpu.io import parsers as r_parsers
    cls = getattr(r_ingest, cls_name, None) or getattr(r_parsers, cls_name)
    with pytest.raises(r_parsers.ParseError) as ei:
        _all(cls(path))
    return ei.value


# --------------------------------------------------------- inflate plans


def test_bgzf_header_detection(tmp_path):
    from racon_tpu.io.inflate import bgzf_block_size as r_size
    p = str(tmp_path / "x.gz")
    _write_bgzf(p, b"hello world")
    blob = open(p, "rb").read()
    size = bgzf_block_size(blob, 0, len(blob))
    assert size is not None and 0 < size <= len(blob)
    assert size == r_size(blob, 0, len(blob))
    assert bgzf_block_size(gzip.compress(b"x"), 0, 99) is None


def test_plan_selection_and_roundtrip(tmp_path):
    cases = {}
    p = str(tmp_path / "bg.fasta.gz")
    _write_bgzf(p, FA_PAYLOAD)
    cases[p] = "bgzf"
    p = str(tmp_path / "mm.fasta.gz")
    _write_members(p, FA_PAYLOAD)
    cases[p] = "members"
    p = str(tmp_path / "st.fasta.gz")
    open(p, "wb").write(gzip.compress(FA_PAYLOAD))
    cases[p] = "stream"
    p = str(tmp_path / "empty.fasta.gz")
    open(p, "wb").close()
    cases[p] = "empty"
    for path, want in cases.items():
        with open_gzip_source(path) as src:
            got = b"".join(src.blocks())
        assert src.mode == want, (path, src.mode)
        assert got == (gzip.open(path).read() if want != "empty" else b"")
    snap = metrics.registry().snapshot()
    assert snap["ingest_inflate_bgzf_sources"] == 1
    assert snap["ingest_bytes_out"] == 3 * len(FA_PAYLOAD)


def test_parser_equivalence_across_plans(tmp_path, monkeypatch):
    """Plain (mmap), BGZF, multi-member and streamed gzip, gate on and
    off: the same records from create_sequence_parser, and the
    reference's."""
    from racon_tpu.io.parsers import create_sequence_parser as r_create
    for tag, payload, ext in (("fa", FA_PAYLOAD, "fasta"),
                              ("fq", FQ_PAYLOAD, "fastq")):
        plain = str(tmp_path / f"{tag}.{ext}")
        open(plain, "wb").write(payload)
        bg = str(tmp_path / f"{tag}_bg.{ext}.gz")
        _write_bgzf(bg, payload)
        mm = str(tmp_path / f"{tag}_mm.{ext}.gz")
        _write_members(mm, payload)
        st = str(tmp_path / f"{tag}_st.{ext}.gz")
        open(st, "wb").write(gzip.compress(payload))
        outs = []
        for path in (plain, bg, mm, st):
            for gate in ("0", "1"):
                monkeypatch.setenv(env.INGEST, gate)
                parser = create_sequence_parser(path)
                indexed = isinstance(parser, (IndexedFastaParser,
                                              IndexedFastqParser))
                assert indexed == (gate == "1" and path == plain)
                outs.append(_recs(parser))
        assert all(o == outs[0] for o in outs), tag
        assert len(outs[0]) == 400
        assert outs[0] == _recs(r_create(plain)), tag


@pytest.mark.parametrize("kind", ["fasta", "fastq"])
def test_chunked_parse_boundary_parity(tmp_path, kind):
    """parse(max_bytes) cuts chunks at the same records on the mmap reader
    as on the serial one and the reference's mmap reader."""
    from racon_tpu.io import ingest as r_ingest
    payload = FA_PAYLOAD if kind == "fasta" else FQ_PAYLOAD
    plain = str(tmp_path / f"x.{kind}")
    open(plain, "wb").write(payload)
    classes = ((FastaParser, IndexedFastaParser,
                r_ingest.IndexedFastaParser) if kind == "fasta" else
               (FastqParser, IndexedFastqParser,
                r_ingest.IndexedFastqParser))
    for mb in (1, 64, 333):
        parsers = [cls(plain) for cls in classes]
        while True:
            chunks = [p.parse(mb) for p in parsers]
            names = [[s.name for s in c] for c, _ in chunks]
            assert names[0] == names[1] == names[2]
            assert len({m for _, m in chunks}) == 1
            assert parsers[1]._pos == parsers[2]._pos
            if not chunks[0][1]:
                break


# ----------------------------------------------------------- zero-copy


def test_zero_copy_invariant_single_line(tmp_path):
    fa = str(tmp_path / "z.fasta")
    open(fa, "wb").write(b">a\nACGTACGTAC\n>b\nTTTTGGGG\n")
    fq = str(tmp_path / "z.fastq")
    open(fq, "wb").write(b"@a\nACGT\n+\nIIII\n@b\nGGCC\n+\nJJJJ\n")
    fa_recs = _all(IndexedFastaParser(fa))
    fq_recs = _all(IndexedFastqParser(fq))
    assert materialized_copies() == 0
    for s in fa_recs + fq_recs:
        assert isinstance(s.data, memoryview), type(s.data)
    assert all(isinstance(s.quality, memoryview) for s in fq_recs)
    from racon_tpu_torch.ops.encode import encode_bases
    assert encode_bases(fa_recs[0].data).tolist() == \
        encode_bases(b"ACGTACGTAC").tolist()


def test_zero_copy_counts_multiline_joins(tmp_path):
    fa = str(tmp_path / "w.fasta")
    open(fa, "wb").write(b">a\nACGT\nACGT\n>b\nGGGG\n")
    recs = _all(IndexedFastaParser(fa))
    assert bytes(recs[0].data) == b"ACGTACGT"
    assert materialized_copies() == 1      # the wrapped record only


# ------------------------------------------------- offset-bearing errors


def test_multimember_truncation_ordinal_and_offset(tmp_path):
    p = str(tmp_path / "t.fasta.gz")
    _write_members(p, FA_PAYLOAD, n=6)
    blob = open(p, "rb").read()
    open(p, "wb").write(blob[:-25])        # tear the final member
    with pytest.raises(ParseError) as ei:
        _all(FastaParser(p))
    msg = str(ei.value)
    assert "member" in msg and "compressed offset" in msg, msg
    assert 0 < ei.value.offset < len(blob)
    ref = _ref_error("FastaParser", p)
    assert ei.value.offset == ref.offset
    assert msg.split("] ", 1)[1] == str(ref).split("] ", 1)[1]


def test_large_gzip_truncation_offset(tmp_path):
    line = bytes(np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(5).integers(0, 4, 1 << 20)])
    payload = b"".join(b">c%d\n%s\n" % (i, line) for i in range(8))
    assert len(payload) > 4 << 20
    p = str(tmp_path / "big.fasta.gz")
    _write_members(p, payload, n=8)
    blob = open(p, "rb").read()
    open(p, "wb").write(blob[:len(blob) // 2])   # cut deep mid-file
    with pytest.raises(ParseError) as ei:
        _all(create_sequence_parser(p))
    msg = str(ei.value)
    assert "compressed offset" in msg and "member" in msg, msg
    assert 0 < ei.value.offset <= len(blob) // 2
    assert ei.value.offset == _ref_error("FastaParser", p).offset


def test_stream_inflate_error_comes_after_every_inflated_block(tmp_path):
    """A torn one-member gzip: the stream source delivers every block it
    inflated before the tear, then the error, however slowly the consumer
    reads; so the parser's offset is where the stream broke (the
    reference's copy drops the queued blocks, and its offset depends on
    the threads' timing)."""
    import time
    payload = b"".join(b">s%d\n%s\n" % (i, b"ACGT" * 400)
                       for i in range(6000))
    blob = gzip.compress(payload)
    p = str(tmp_path / "torn.fasta.gz")
    open(p, "wb").write(blob[:len(blob) // 2])
    outs = []
    for delay in (0.0, 0.05):
        got = []
        with pytest.raises(EOFError):
            with open_gzip_source(p) as src:
                assert src.mode == "stream"
                for block in src:
                    got.append(block)
                    time.sleep(delay)
        outs.append(b"".join(got))
    assert outs[0] == outs[1] and len(outs[0]) >= 1 << 20
    assert payload.startswith(outs[0])
    with pytest.raises(ParseError, match="corrupt or mislabelled") as ei:
        _all(FastaParser(p))
    assert 0 < ei.value.offset <= len(outs[0])


@pytest.mark.parametrize("bad,name", [
    (b"@ok\nACGT\n+\nIIII\n@broke\nACGT\n+\nIIIIII\n", "'broke'"),
    (b"@ok\nACGT\n+\nIIII\n@cut\nACGT\n+\nII", "truncated FASTQ"),
    (b"@ok\nACGT\n+\nIIII\n@cut\nACGT\n", "truncated FASTQ")])
def test_fastq_errors_name_record_and_offset(tmp_path, bad, name):
    p = str(tmp_path / "bad.fastq")
    open(p, "wb").write(bad)
    msgs = []
    for cls in (FastqParser, IndexedFastqParser):
        with pytest.raises(ParseError) as ei:
            _all(cls(p))
        assert name in str(ei.value)
        assert ei.value.offset == bad.rindex(b"\n@") + 1
        msgs.append(str(ei.value).split("] ", 1)[1])
    assert msgs[0] == msgs[1]
    for cls_name in ("FastqParser", "IndexedFastqParser"):
        ref = _ref_error(cls_name, p)
        assert ref.offset == ei.value.offset
        assert str(ref).split("] ", 1)[1] == msgs[0]


def test_failed_parser_stays_poisoned_until_reset(tmp_path):
    p = str(tmp_path / "t.fasta.gz")
    _write_members(p, FA_PAYLOAD, n=4)
    blob = open(p, "rb").read()
    open(p, "wb").write(blob[:-25])
    parser = FastaParser(p)
    with pytest.raises(ParseError):
        parser.parse(-1)
    with pytest.raises(ParseError, match="previously failed"):
        parser.parse(-1)
    open(p, "wb").write(blob)
    assert len(_all(parser)) == 400   # reset() clears the failure


def test_prefetch_gate(monkeypatch):
    assert prefetch_ok() and ingest.ingest_enabled()
    for off in ("0", "false"):
        monkeypatch.setenv(env.INGEST, off)
        assert not prefetch_ok()
    monkeypatch.setenv(env.INGEST, "1")
    assert prefetch_ok()


# --------------------------------------------------- prefetch overlap


def test_prefetcher_matches_serial_chunks(tmp_path):
    p = str(tmp_path / "pf.fastq")
    open(p, "wb").write(FQ_PAYLOAD)
    serial = [[s.name for s in chunk]
              for chunk, _ in serial_chunks(FastqParser(p), 700)]
    pf = IngestPrefetcher(FastqParser(p), 700, "test")
    try:
        streamed = [[s.name for s in chunk] for chunk, _ in pf.chunks()]
    finally:
        pf.close()
    assert streamed == serial and sum(map(len, serial)) == 400
    assert len(serial) > 1
    snap = metrics.registry().snapshot()
    assert snap["ingest_parse_serial_files"] == 1
    assert snap["ingest_parse_prefetch_files"] == 1
    assert snap["ingest_records"] == 800


def test_prefetcher_propagates_parse_error(tmp_path):
    p = str(tmp_path / "bad.fastq")
    open(p, "wb").write(b"@a\nACGT\n+\nIIII\nnot a header\n")
    pf = IngestPrefetcher(FastqParser(p), CHUNK_SIZE, "err")
    try:
        with pytest.raises(ParseError, match="malformed FASTQ"):
            for _chunk in pf.chunks():
                pass
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_close_is_safe_midstream(tmp_path):
    p = str(tmp_path / "mid.fasta")
    open(p, "wb").write(FA_PAYLOAD)
    pf = IngestPrefetcher(FastaParser(p), 100, "abandon")
    next(iter(pf.chunks()))
    pf.close()                             # abandons, no hang
    pf._thread.join(timeout=T)
    assert not pf._thread.is_alive()
    pf.close()                             # idempotent


# ------------------------------------------------------ CLI differential


def _cli_inputs(tmp_path, gz=False):
    """tests/test_ingest.py's inputs: one 360 bp contig, 7 reads, PAF."""
    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", np.uint8)
    truth = bases[rng.integers(0, 4, 360)]

    def noisy():
        out = []
        for b in truth:
            r = rng.random()
            if r < 0.04:
                continue
            out.append(int(bases[rng.integers(0, 4)]) if r < 0.08
                       else int(b))
        return bytes(out)

    draft = noisy()
    reads, paf = [], []
    for i in range(7):
        r = noisy()
        reads.append(b">r%d\n%s\n" % (i, r))
        paf.append(f"r{i}\t{len(r)}\t0\t{len(r)}\t+\tc1\t{len(draft)}"
                   f"\t0\t{len(draft)}\t{min(len(r), len(draft))}"
                   f"\t{max(len(r), len(draft))}\t60".encode())
    files = {"draft.fasta": b">c1\n" + draft + b"\n",
             "reads.fasta": b"".join(reads),
             "ovl.paf": b"\n".join(paf) + b"\n"}
    out = []
    for name, data in files.items():
        path = tmp_path / (name + (".gz" if gz else ""))
        path.write_bytes(gzip.compress(data) if gz else data)
        out.append(str(path))
    return out[1], out[2], out[0]          # reads, ovl, draft


def _run(cli, argv):
    stdout = io.StringIO()
    stdout.buffer = io.BytesIO()
    with contextlib.redirect_stdout(stdout), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    assert rc == 0
    return stdout.buffer.getvalue()


def test_cli_gate_differential_matches_reference(tmp_path, monkeypatch):
    """RACON_TPU_INGEST=0 and =1, plain and gzipped inputs: the port
    CLI's four FASTAs equal the reference CLI's."""
    from racon_tpu import cli as r_cli
    from racon_tpu_torch import cli
    plain = _cli_inputs(tmp_path, gz=False)
    gz = _cli_inputs(tmp_path, gz=True)
    ref = _run(r_cli, ["--backend", "jax", *plain])
    assert ref.startswith(b">c1 LN:i:")
    for group in (plain, gz):
        for gate in ("0", "1"):
            monkeypatch.setenv(env.INGEST, gate)
            metrics.reset()
            assert _run(cli, [*group, "--device", "cpu"]) == ref, \
                (group[0], gate)
            snap = metrics.registry().snapshot()
            mode = "prefetch" if gate == "1" else "serial"
            assert snap[f"ingest_parse_{mode}_files"] == 3
            assert snap["ingest_records"] == 7 + 7 + 1
            assert snap["ingest_wait_s"] >= 0
            if gate == "1" and group is gz:
                assert snap["ingest_inflate_stream_sources"] == 3
