"""The port's StreamingCounter against kmers_tpu's, fed the same batches on
the CPU: the same table, counters and checkpoint content, with and
without eviction, and checkpoints that resume across the two packages."""

import numpy as np
import pytest
import torch

from kmers_tpu.io.fastx import pack_batch_np
from kmers_tpu.parallel.stream import StreamingCounter as JaxCounter
from kmers_tpu_torch import convert
from kmers_tpu_torch.io import simulate
from kmers_tpu_torch.parallel import count as tcount
from kmers_tpu_torch.parallel.stream import StreamingCounter, npz_digest

K = 25
B, L = 16, 128


def batches(seed, n=5):
    """n [B, L] ASCII batches of simulated 100 bp reads, N-padded."""
    reads = next(simulate.iter_reads(3000, n * B, 100, 0.01, 0.005, seed))
    rows = np.full((n * B, L), ord("N"), np.uint8)
    rows[:, :100] = reads
    return [rows[i * B:(i + 1) * B] for i in range(n)]


def feed(sc, rows_list, packed):
    for rows in rows_list:
        if packed:
            sc.update_packed(*pack_batch_np(rows))
        else:
            sc.update(rows)


def jax_counter(capacity, merge_every):
    return JaxCounter(K, capacity, merge_every=merge_every)


def port_counter(capacity, merge_every):
    return StreamingCounter(K, capacity, merge_every=merge_every,
                            device="cpu")


def saved_digest(sc, path):
    sc.save(str(path))
    return npz_digest(str(path) + ".npz")


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("capacity,merge_every", [
    (8192, 2),    # no eviction; the last consolidation is padded
    (512, 2),     # evicts at every consolidation
])
def test_streaming_counter_matches_jax(tmp_path, packed, capacity,
                                       merge_every):
    rows = batches(1)
    j = jax_counter(capacity, merge_every)
    t = port_counter(capacity, merge_every)
    feed(j, rows, packed)
    feed(t, rows, packed)
    assert (saved_digest(t, tmp_path / "t") == saved_digest(j, tmp_path / "j"))
    assert (t.dropped_unique, t.dropped_kmers) == (j.dropped_unique,
                                                   j.dropped_kmers)
    assert (t.dropped_unique > 0) == (capacity < 8192)
    assert t.to_pairs() == j.to_pairs()


def test_eviction_order_dead_last_count_desc_key_asc():
    """Ties at the eviction boundary evict the largest keys first."""
    keys = torch.tensor([5, 9, 2, 7, 3, 11], dtype=torch.int64)
    counts = torch.tensor([1, 3, 1, 3, 2, 1], dtype=torch.int32)
    order = torch.argsort(keys)
    hi, lo = (x.contiguous() for x in
              torch.stack([keys[order] >> 32, keys[order] & 0xFFFFFFFF])
              .to(torch.int32))
    merged = tcount.CountTable(hi, lo, counts[order], 6)
    from kmers_tpu_torch.parallel.stream import _bound_table

    out, du, dk = _bound_table(merged, 4)
    # kept: counts 3 (keys 7, 9), 2 (key 3), and of the count-1 keys
    # {2, 5, 11} the smallest, 2
    assert out.keys_lo.tolist() == [2, 3, 7, 9]
    assert out.counts.tolist() == [1, 2, 3, 3]
    assert (du, dk) == (2, 2)


def test_padding_tables_are_dead_not_zero():
    """merge_every padding: an all-zero unit table would count key 0
    `capacity` times; padding lanes must be (0x80000000, 0)."""
    unit = tcount.UnitTable(torch.arange(8, dtype=torch.int32),
                            torch.arange(8, dtype=torch.int32))
    pad = tcount.empty_like_table(unit)
    assert (pad.keys_hi.numpy().view(np.uint32) == 0x80000000).all()
    assert (pad.keys_lo == 0).all()
    table = tcount.empty_like_table(tcount.empty_table(4, "cpu"))
    assert table.n_unique == 0 and (table.counts == 0).all()
    # a partial consolidation (padded) counts exactly the real batches
    rows = batches(2, n=3)
    t = port_counter(8192, 8)
    feed(t, rows, packed=True)
    want = port_counter(8192, 1)
    feed(want, rows, packed=True)
    assert t.to_pairs() == want.to_pairs()
    assert t.kmers == want.kmers == sum(c for _, c in t.to_pairs())


def test_save_load_round_trip_and_resume(tmp_path):
    rows = batches(3)
    whole = port_counter(8192, 2)
    feed(whole, rows, packed=True)
    part = port_counter(8192, 2)
    feed(part, rows[:3], packed=True)
    part.save(str(tmp_path / "ckpt"))
    back = StreamingCounter.load(str(tmp_path / "ckpt"), device="cpu")
    assert back.batches == 3 and back.kmers == part.kmers
    assert back.to_pairs() == part.to_pairs()
    back.merge_every = 2
    feed(back, rows[3:], packed=True)
    assert back.to_pairs() == whole.to_pairs()
    assert back.kmers == whole.kmers and back.batches == whole.batches


@pytest.mark.parametrize("capacity", [8192, 512])
def test_checkpoints_resume_across_packages(tmp_path, capacity):
    """A kmers_tpu checkpoint resumes in the port and a port checkpoint in
    kmers_tpu; both continuations save the same content."""
    rows = batches(4)
    j = jax_counter(capacity, 2)
    feed(j, rows[:3], packed=True)
    j.save(str(tmp_path / "j3"))
    t = port_counter(capacity, 2)
    feed(t, rows[:3], packed=True)
    t.save(str(tmp_path / "t3"))
    assert npz_digest(str(tmp_path / "j3.npz")) == npz_digest(
        str(tmp_path / "t3.npz"))

    t_from_j = StreamingCounter.load(str(tmp_path / "j3"), device="cpu")
    j_from_t = JaxCounter.load(str(tmp_path / "t3"))
    for sc in (t_from_j, j_from_t):
        sc.merge_every = 2
        feed(sc, rows[3:], packed=True)
    assert (saved_digest(t_from_j, tmp_path / "a")
            == saved_digest(j_from_t, tmp_path / "b"))


def test_convert_round_trip():
    rng = np.random.default_rng(0)
    hi = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(0, 1000, 64).astype(np.int32)
    table = convert.table_from_numpy(hi, lo, counts, 40, "cpu")
    assert table.keys_hi.dtype == torch.int32 and table.n_unique == 40
    back = convert.table_to_numpy(table)
    np.testing.assert_array_equal(back["keys_hi"], hi)
    np.testing.assert_array_equal(back["keys_lo"], lo)
    np.testing.assert_array_equal(back["counts"], counts)
    assert back["keys_hi"].dtype.str == "<u4"
    assert back["counts"].dtype.str == "<i4"
    with pytest.raises(ValueError):
        convert.table_from_numpy(hi, lo, counts, 65, "cpu")


@pytest.mark.parametrize("length", [128, 100])     # packed, ASCII rows
def test_count_fastx_matches_jax(tmp_path, length):
    from kmers_tpu.parallel.stream import count_fastx as jax_count_fastx
    from kmers_tpu_torch.parallel.stream import count_fastx

    fq = str(tmp_path / "r.fastq")
    simulate.write_fastq(fq, 3000, 70, 100, 0.01, 0.005, 6)
    args = dict(k=K, capacity=4096, batch=B, length=length, merge_every=2)
    j = jax_count_fastx(fq, **args)
    t = count_fastx(fq, device="cpu", **args)
    assert (t.batches, t.kmers) == (j.batches, j.kmers)
    assert t.to_pairs() == j.to_pairs()


def test_counter_rejects_unported_k():
    """k = 32 and k = 64 count (run-length batches); k outside
    1..64 is refused."""
    rows = batches(5, n=2)
    for k in (32, 64):
        sc = StreamingCounter(k, 1 << 13, device="cpu")
        assert sc.spec.aggregate == "runlength" and sc.wide == (k == 64)
        feed(sc, rows, packed=True)
        pairs = sc.to_pairs()
        assert sc.kmers == sum(c for _, c in pairs) > 0
        assert [w for w, _ in pairs] == sorted(w for w, _ in pairs)
    for k in (0, 65):
        with pytest.raises(ValueError):
            StreamingCounter(k, 64, device="cpu")
