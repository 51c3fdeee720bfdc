import pytest




def test_threads_byte_identical(tmp_path):
    """-t N must not change output bytes: the thread pool only moves each
    group's encode/dispatch off the caller's thread; gather order is FIFO
    (the reference's OpenMP gather restores order by index the same way,
    src/main.cpp:103-120)."""
    import numpy as np

    from stringdecomposer_tpu.pipeline import run

    rng = np.random.default_rng(9)
    alpha = np.array(list("ACGT"))
    monos = ["".join(rng.choice(alpha, 12)) for _ in range(3)]
    seqs = tmp_path / "s.fa"
    mono_fa = tmp_path / "m.fa"
    reads = []
    for r in range(4):
        reads.append("".join(monos[int(rng.integers(3))] for _ in range(40)))
    seqs.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    mono_fa.write_text("".join(f">m{j}\n{s}\n" for j, s in enumerate(monos)))
    run(str(seqs), str(mono_fa), out_dir=str(tmp_path / "t1"),
        batch_size=64, overlap=8, second_best=True, device_batch=8, threads=1)
    run(str(seqs), str(mono_fa), out_dir=str(tmp_path / "t4"),
        batch_size=64, overlap=8, second_best=True, device_batch=8, threads=4)
    for name in ["final_decomposition.tsv", "final_decomposition_alt.tsv",
                 "final_decomposition_raw.tsv"]:
        a = (tmp_path / "t1" / name).read_text()
        b = (tmp_path / "t4" / name).read_text()
        assert a and a == b, name


def _pad_batch(seqs):
    import numpy as np

    L = max(1, max(len(c) for c in seqs))
    arr = np.full((len(seqs), L), 7, dtype=np.int8)
    lens = np.zeros(len(seqs), dtype=np.int32)
    for i, c in enumerate(seqs):
        arr[i, : len(c)] = c
        lens[i] = len(c)
    return arr, lens


@pytest.mark.parametrize("blocks, n_pad", [
    # scrambled: short, medium, one long outlier, repeated starts, 1-bp
    ([(5, 20), (100, 17), (0, 230), (40, 8), (300, 60), (100, 17), (550, 50), (7, 1)], 16),
    ([(3, 17)], 8),  # a single block, pad rows beyond it
    ([(s, 17) for s in range(0, 540, 17)], 32),  # a tandem run, no padding
])
def test_packed_both_matches_pairwise_scan(blocks, n_pad):
    """The packed finishing path (ops/identity.nw_identity_packed_both, the
    CPU's scan route): block extraction from the resident read, on-device
    homo collapse and the cross product reproduce the per-pair scan for
    BOTH variants, including zero-length pad rows."""
    import jax.numpy as jnp
    import numpy as np

    from stringdecomposer_tpu.finishing import _pad_codes, _upload_read, homo_compress
    from stringdecomposer_tpu.io.fasta import encode
    from stringdecomposer_tpu.ops.identity import nw_identity_batch, nw_identity_packed_both

    rng = np.random.default_rng(23)
    alpha = list("ACGT")
    unit = "".join(rng.choice(alpha, 17))
    read = encode((unit * 40)[:600])
    starts = np.array([s for s, _ in blocks], dtype=np.int64)
    lens = np.array([ln for _, ln in blocks], dtype=np.int32)
    monos = ["".join(rng.choice(alpha, int(n))) for n in (17, 23, 11)]
    mono_codes = [encode(m) for m in monos]
    homo_codes = [encode(homo_compress(m)) for m in monos]
    t_raw, tl_raw = _pad_codes(mono_codes)
    t_homo, tl_homo = _pad_codes(homo_codes)
    out = np.asarray(nw_identity_packed_both(
        _upload_read(read), starts, lens,
        jnp.asarray(t_raw), tl_raw, jnp.asarray(t_homo), tl_homo,
        n_pad=n_pad, Lq=256,
    )).astype(np.int64)  # [2, n_pad*M, 2]
    M = len(monos)
    for v, variant_codes in enumerate((mono_codes, homo_codes)):
        subs = []
        for s, ln in blocks:
            sub = read[s : s + ln]
            subs.append(sub if v == 0 else sub[np.concatenate(([True], sub[1:] != sub[:-1]))])
        q, ql = _pad_batch([sub for sub in subs for _ in range(M)])
        t, tl = _pad_batch([tc for _ in subs for tc in variant_codes])
        d0, m0, l0 = (np.asarray(x) for x in nw_identity_batch(q, ql, t, tl))
        got = out[v].reshape(-1, M, 2)[: len(blocks)].reshape(-1, 2)
        np.testing.assert_array_equal(got[:, 0], d0)  # distance
        np.testing.assert_array_equal(got[:, 1], l0)  # columns
        np.testing.assert_array_equal(got[:, 1] - got[:, 0], m0)  # matches


def test_packed_path_matches_generic_path():
    """finish_reads on the packed device path (the default) and on the
    generic pairwise path (a caller's own kernel) emit the same rows."""
    import io

    import numpy as np

    from stringdecomposer_tpu.finishing import finish_reads, write_final_rows
    from stringdecomposer_tpu.io.fasta import Record, add_rc_interleaved
    from stringdecomposer_tpu.ops.identity import nw_identity_batch

    rng = np.random.default_rng(5)
    alpha = np.array(list("ACGT"))
    monos = add_rc_interleaved([Record(f"m{j}", "".join(rng.choice(alpha, 21)))
                                for j in range(3)])
    reads = {i: "".join(rng.choice(alpha, 400)) for i in range(2)}
    per_read = [(f"r{i}", [{"m": monos[(i + b) % 6].name, "start": 20 * b,
                            "end": 20 * b + 18 + b % 3} for b in range(15)], i)
                for i in reads]

    def emit(kernel):
        fin, alt = io.StringIO(), io.StringIO()
        write_final_rows(fin, alt, finish_reads(per_read, reads, monos, second_best=True,
                                                kernel=kernel))
        return fin.getvalue(), alt.getvalue()

    packed, generic = emit(None), emit(nw_identity_batch)
    assert packed[0] and packed == generic
