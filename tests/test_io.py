import gzip
import os

import numpy as np
import pytest

from midas_tpu.io import (
    batch_reads,
    decode_seq,
    encode_seq,
    load_read_batches,
    revcomp_codes,
    stream_reads,
)
from midas_tpu.io.seqio import read_fastx
from tests import refmidas


def test_encode_decode_roundtrip():
    seq = "ACGTNacgtn"
    codes = encode_seq(seq)
    assert list(codes) == [0, 1, 2, 3, 4, 0, 1, 2, 3, 4]
    assert decode_seq(codes) == "ACGTNACGTN"


def test_revcomp():
    assert decode_seq(revcomp_codes(encode_seq("AACGT"))) == "ACGTT"
    assert decode_seq(revcomp_codes(encode_seq("AN"))) == "NT"


def test_read_fastx_fastq(tmp_path):
    p = tmp_path / "r.fq"
    p.write_text("@r1 desc\nACGT\n+\nIIII\n@r2\nGGCC\n+\n!!!!\n")
    with open(p) as f:
        recs = list(read_fastx(f))
    assert recs == [("r1", "ACGT", "IIII"), ("r2", "GGCC", "!!!!")]


def test_read_fastx_multiline_fasta(tmp_path):
    p = tmp_path / "r.fa"
    p.write_text(">s1\nACGT\nACGT\n>s2\nTTTT\n")
    with open(p) as f:
        recs = list(read_fastx(f))
    assert recs == [("s1", "ACGTACGT", None), ("s2", "TTTT", None)]


def test_stream_reads_trim_and_cap(tmp_path):
    p = tmp_path / "r.fq.gz"
    with gzip.open(p, "wt") as f:
        for i, n in enumerate([50, 100, 120]):
            f.write(f"@r{i}\n{'A' * n}\n+\n{'I' * n}\n")
    # reference semantics (stream_seqs.py:52-58): drop < L, trim to L
    recs = list(stream_reads(str(p), read_length=100))
    assert [r[0] for r in recs] == ["r1", "r2"]
    assert all(len(r[1]) == 100 for r in recs)
    recs = list(stream_reads(str(p), max_reads=2))
    assert len(recs) == 2


def test_batch_shapes(tmp_path):
    p = tmp_path / "r.fq"
    p.write_text("".join(f"@r{i}\n{'ACGT' * 20}\n+\n{'I' * 80}\n" for i in range(5)))
    batches = list(load_read_batches(str(p), batch_size=4, max_len=128))
    assert len(batches) == 2
    b0, b1 = batches
    assert b0.codes.shape == (4, 128) and b1.codes.shape == (4, 128)
    assert b0.n_reads == 4 and b1.n_reads == 1
    assert list(b0.lengths) == [80] * 4
    assert np.all(b0.codes[0, 80:] == 4)  # sentinel padding
    assert np.isclose(b0.mean_qual[0], 40.0)


REF_FQ = os.path.join(refmidas.REF_ROOT, "test", "test.fq.gz")


@pytest.mark.skipif(not os.path.exists(REF_FQ),
                    reason="reference MIDAS test fixture unavailable")
def test_reference_test_fastq_parses():
    # the reference fixture: 2,500 single-end 100bp reads
    recs = list(stream_reads(REF_FQ))
    assert len(recs) == 2500
    assert all(len(s) == 100 for _n, s, _q in recs)
