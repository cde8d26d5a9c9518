"""The banded-DP dispatch and the CUDA kernel's Python side.

On the CPU these check what surrounds the kernel: the choice of
implementation by platform, score-only against full statistics,
pair counts that fill no whole block, the quality-penalty plumbing, and
the FFI call's shapes, dtypes and attributes. The kernel itself has no
CPU mode: the `gpu`-marked tests compare it bit for bit with
banded_align on a card (and chip_smoke.py does so at full width)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from midas_tpu.align import banded_cuda
from midas_tpu.align.banded import banded_align
from midas_tpu.align.params import (GLOBAL_SCORING, LOCAL_SCORING,
                                    MARKER_SCORING)
from midas_tpu.align.pipeline import (SCORE_ONLY_KEYS, _prepare_pairs,
                                      dispatch_banded_align,
                                      dp_for_platform, plain_banded_align,
                                      quality_penalties)

PERSONALITIES = [GLOBAL_SCORING, LOCAL_SCORING, MARKER_SCORING]
D = 16


def _case(seed, P=96, L=64):
    """Reads from their windows with substitutions, an indel in every
    fifth pair, read Ns, short and empty reads."""
    rng = np.random.default_rng(seed)
    W = L + D - 1
    ref = rng.integers(0, 4, size=(P, W)).astype(np.int8)
    q = np.full((P, L), 4, dtype=np.int8)
    qlens = np.zeros(P, dtype=np.int32)
    for i in range(P):
        n = [L, L - 12, L - 30, 0][i % 4]
        frag = ref[i, D // 2: D // 2 + n].copy()
        k = i % 4
        if k and n:
            pos = rng.choice(n, k, replace=False)
            frag[pos] = (frag[pos] + 1) % 4
        if i % 5 == 0 and n > 20:
            frag = np.delete(frag, 12)
        if i % 7 == 0 and n:
            frag[n // 2 - 1] = 4
        q[i, : len(frag)] = frag
        qlens[i] = len(frag)
    quals = rng.integers(2, 42, size=(P, L)).astype(np.int8)
    return (jnp.asarray(q), jnp.asarray(qlens), jnp.asarray(ref),
            jnp.asarray(quals))


@pytest.mark.parametrize("params", PERSONALITIES,
                         ids=["global", "local", "marker"])
def test_score_only_agrees_with_full(params):
    """Pass 1 of the two-pass alignment (score-only) picks the same
    cells as the full-statistics DP."""
    q, qlens, ref, quals = _case(11)
    qpen = quality_penalties(quals, params) if params.qual_scaled else None
    full = dispatch_banded_align(q, qlens, ref, params, D, qpen_pair=qpen)
    fast = dispatch_banded_align(q, qlens, ref, params, D, score_only=True,
                                 qpen_pair=qpen)
    assert tuple(fast) == SCORE_ONLY_KEYS
    for k in SCORE_ONLY_KEYS:
        np.testing.assert_array_equal(np.asarray(fast[k]),
                                      np.asarray(full[k]), err_msg=k)


def test_pair_count_needs_no_padding():
    """A pair count that fills no whole kernel block (16 pairs) gives
    the same rows as the same pairs inside a larger batch."""
    q, qlens, ref, _ = _case(3, P=128)
    whole = dispatch_banded_align(q, qlens, ref, GLOBAL_SCORING, D)
    part = dispatch_banded_align(q[:101], qlens[:101], ref[:101],
                                 GLOBAL_SCORING, D)
    for k, v in part.items():
        assert v.shape == (101,), k
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(whole[k])[:101], err_msg=k)


def test_qpen_plumbing():
    """Penalties reach the DP: at Q40 they equal the flat model; at low
    quality mismatches cost less; rc-strand candidates carry the
    penalties reversed (they follow the read base they qualify)."""
    q, qlens, ref, quals = _case(5)
    q40 = quality_penalties(jnp.full_like(quals, 40), GLOBAL_SCORING)
    assert int(q40.min()) == int(q40.max()) == -GLOBAL_SCORING.mismatch
    flat = dispatch_banded_align(q, qlens, ref, GLOBAL_SCORING, D)
    at40 = dispatch_banded_align(q, qlens, ref, GLOBAL_SCORING, D,
                                 qpen_pair=q40)
    # read Ns cost --np instead of MX, so compare N-free reads only
    clean = np.asarray(jnp.all(q < 4, axis=1) | (qlens == 0))
    np.testing.assert_array_equal(np.asarray(at40["score"])[clean],
                                  np.asarray(flat["score"])[clean])
    low = quality_penalties(jnp.full_like(quals, 2), GLOBAL_SCORING)
    cheap = dispatch_banded_align(q, qlens, ref, GLOBAL_SCORING, D,
                                  qpen_pair=low)
    assert np.all(np.asarray(cheap["score"]) >= np.asarray(at40["score"]))
    assert np.any(np.asarray(cheap["score"]) > np.asarray(at40["score"]))

    codes, lens = q[:4], jnp.asarray([64, 50, 64, 20], jnp.int32)
    pen = quals[:4]
    strand = jnp.asarray([[0, 1], [1, 0], [0, 0], [1, 1]], jnp.int32)
    _, _, qpen_pair = _prepare_pairs(codes, lens, strand, num_cands=2,
                                     qpen=pen)
    qpen_pair = np.asarray(qpen_pair).reshape(4, 2, -1)
    for b in range(4):
        n = int(lens[b])
        fwd = np.asarray(pen[b, :n])
        for c in range(2):
            want = fwd[::-1] if int(strand[b, c]) == 1 else fwd
            np.testing.assert_array_equal(qpen_pair[b, c, :n], want)


@pytest.mark.parametrize("platform,want", [
    ("cpu", plain_banded_align),
    ("gpu", banded_cuda.banded_align_cuda),
    ("rocm", NotImplementedError),
])
def test_dp_for_platform(platform, want):
    if want is NotImplementedError:
        with pytest.raises(NotImplementedError):
            dp_for_platform(platform)
    else:
        assert dp_for_platform(platform) is want


@pytest.mark.parametrize("score_only", [False, True])
@pytest.mark.parametrize("params", [GLOBAL_SCORING, MARKER_SCORING],
                         ids=["global", "marker"])
def test_ffi_call_shapes_and_attributes(score_only, params):
    """The FFI call as traced (no library needed): int8/int32 operands
    in row-major [P, L] / [P, W] layout, a [P] score and a [rows, P]
    statistics result, and the scoring as attributes."""
    P, L = 40, 32
    q = jnp.zeros((P, L), jnp.int8)
    qlens = jnp.full((P,), L, jnp.int32)
    win = jnp.zeros((P, L + D - 1), jnp.int8)
    qpen = jnp.ones((P, L), jnp.int8) if params.qual_scaled else None
    jaxpr = jax.make_jaxpr(
        lambda a, b, c: banded_cuda.ffi_banded(a, b, c, qpen, params, D,
                                               score_only))(q, qlens, win)
    (eqn,) = [e for e in jaxpr.eqns if e.primitive.name == "ffi_call"]
    assert eqn.params["target_name"] == banded_cuda.TARGET
    ins = [(v.aval.shape, v.aval.dtype) for v in eqn.invars]
    qpen_shape = (P, L) if params.qual_scaled else (1,)
    assert ins == [((P, L), jnp.int8), ((P,), jnp.int32),
                   ((P, L + D - 1), jnp.int8), (qpen_shape, jnp.int8)]
    rows = banded_cuda.SCORE_ROWS if score_only else banded_cuda.FULL_ROWS
    outs = [(v.aval.shape, v.aval.dtype) for v in eqn.outvars]
    assert outs == [((P,), jnp.float32), ((len(rows), P), jnp.int32)]
    attrs = dict(eqn.params["attributes"])
    assert attrs["band_width"] == D
    assert attrs["local"] == int(params.mode == "local")
    assert attrs["score_only"] == int(score_only)
    assert attrs["qual_pen"] == int(params.qual_scaled)
    assert attrs["gap_open"] == params.gap_open
    assert attrs["mismatch"] == params.mismatch


def test_unpack_names_rows():
    P = 5
    score = jnp.arange(P, dtype=jnp.float32)
    for score_only, rows in ((False, banded_cuda.FULL_ROWS),
                             (True, banded_cuda.SCORE_ROWS)):
        stats = jnp.arange(len(rows) * P, dtype=jnp.int32).reshape(-1, P)
        out = banded_cuda.unpack(score, stats, score_only)
        assert set(out) == {"score", *rows}
        for i, k in enumerate(rows):
            np.testing.assert_array_equal(np.asarray(out[k]),
                                          np.arange(P) + i * P)
    assert set(banded_cuda.FULL_ROWS) | {"score"} == set(
        plain_banded_align(*_case(1, P=4)[:3], GLOBAL_SCORING, D))


def test_unsupported_band_width_raises():
    q, qlens, ref, _ = _case(2, P=8)
    with pytest.raises(ValueError, match="band_width"):
        banded_cuda.ffi_banded(q[:, :56], qlens, ref[:, :63], None,
                               GLOBAL_SCORING, 8, False)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No compiler: the build fails loudly instead of falling back."""
    import midas_tpu.runtime

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(midas_tpu.runtime, "build_dir",
                        lambda: str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        banded_cuda.build()


@pytest.mark.gpu
@pytest.mark.parametrize("score_only", [False, True])
@pytest.mark.parametrize("params", PERSONALITIES,
                         ids=["global", "local", "marker"])
def test_kernel_matches_banded(gpu, params, score_only):
    q, qlens, ref, quals = _case(7, P=200, L=96)
    for qpen in (None, quality_penalties(quals, params)):
        want = banded_align(q, qlens, ref, params, D, qpen=qpen)
        got = banded_cuda.banded_align_cuda(q, qlens, ref, params, D,
                                            score_only=score_only,
                                            qpen=qpen)
        assert set(got) == (set(SCORE_ONLY_KEYS) if score_only
                            else set(want))
        for k in got:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
