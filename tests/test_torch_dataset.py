"""The dataset tier of paddle_tpu_torch against paddle_tpu's, exactly.

The same MultiSlot text files (written from a seed: two sparse slots of
1 to 4 ids each, some ids past 2^32, a dense slot of 3 floats and a
label) go through both packages: ``PyDataFeed`` batch for batch (ids,
lod and dense values), ``InMemoryDataset`` and ``QueueDataset``
(densified feed dicts, one parsing thread; the reference's own feed is
its C++ one where that library is built, and its threads would interleave
the files), ``local_shuffle`` and the Python ``global_shuffle``
from one seed, the CSR packers and the record routing hash.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu.native as jnative
from paddle_tpu.fluid.framework import reset_unique_name as j_reset

import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.native as tnative
from paddle_tpu_torch.fluid.framework import reset_unique_name as t_reset


def _write(tmp_path, seed=9, n_files=3, lines=21):
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n_files):
        rows = []
        for _ in range(lines):
            toks = []
            for _slot in range(2):
                n = rng.randint(1, 5)
                ids = rng.randint(0, 2 ** 40, n)
                toks += [str(n)] + [str(int(v)) for v in ids]
            dense = rng.randn(3)
            toks += ["3"] + ["%f" % v for v in dense]
            toks += ["1", "%d" % rng.randint(0, 2)]
            rows.append(" ".join(toks))
        p = tmp_path / f"part-{i}"
        p.write_text("\n".join(rows) + "\n")
        paths.append(str(p))
    return paths


def _slots(native):
    return [native.SlotDesc("a", False), native.SlotDesc("b", False),
            native.SlotDesc("d", True, 3), native.SlotDesc("y", True, 1)]


def _same_batch(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], tuple):
            for g, w in zip(got[k], want[k]):
                assert g.dtype == np.int64
                np.testing.assert_array_equal(g, w)
        else:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def _feed_batches(native, paths, batch, shuffle=None):
    f = native.PyDataFeed(_slots(native), batch)
    f.set_filelist(paths)
    f.load_into_memory()
    if shuffle is not None:
        f.local_shuffle(shuffle)
    f.start_from_memory()
    return list(f)


@pytest.mark.parametrize("batch,shuffle", [(5, None), (8, None), (5, 3)])
def test_py_data_feed_batches_equal_the_reference(tmp_path, batch, shuffle):
    paths = _write(tmp_path)
    want = _feed_batches(jnative, paths, batch, shuffle)
    got = _feed_batches(tnative, paths, batch, shuffle)
    assert len(got) == len(want) == -(-63 // batch)
    for g, w in zip(got, want):
        _same_batch(g, w)


def test_streaming_feed_equals_in_memory(tmp_path):
    paths = _write(tmp_path)
    f = tnative.PyDataFeed(_slots(tnative), 7)
    f.set_filelist(paths)
    f.start()
    for g, w in zip(list(f), _feed_batches(tnative, paths, 7)):
        _same_batch(g, w)


def _use_vars(fluid, reset):
    reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        return [fluid.data("a", [-1, 1], dtype="int64"),
                fluid.data("b", [-1, 1], dtype="int64"),
                fluid.data("d", [-1, 3]), fluid.data("y", [-1, 1])]


def _dataset_batches(fluid, reset, kind, paths, batch):
    ds = fluid.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(batch)
    ds.set_thread(1)
    ds.set_use_var(_use_vars(fluid, reset))
    ds.set_filelist(paths)
    if kind == "InMemoryDataset":
        ds.load_into_memory()
        assert ds.get_memory_data_size() == 63
    return list(ds._iter_batches())


@pytest.mark.parametrize("kind", ("InMemoryDataset", "QueueDataset"))
def test_dataset_batches_equal_the_reference(tmp_path, kind):
    """Densified feed dicts: ragged id slots padded with 0 to the batch's
    longest row, dense slots float32."""
    paths = _write(tmp_path)
    want = _dataset_batches(jfluid, j_reset, kind, paths, 6)
    got = _dataset_batches(tfluid, t_reset, kind, paths, 6)
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            w_k = np.asarray(w[k])
            assert g[k].dtype == w_k.dtype and g[k].shape == w_k.shape, k
            np.testing.assert_array_equal(g[k], w_k)


def test_in_memory_dataset_lifecycle(tmp_path):
    ds = tfluid.DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_batch_size(4)
    ds.set_use_var(_use_vars(tfluid, t_reset))
    ds.set_filelist(_write(tmp_path))
    with pytest.raises(RuntimeError):
        ds.local_shuffle()
    with pytest.raises(RuntimeError):
        list(ds._iter_batches())
    ds.load_into_memory()
    ds.local_shuffle(1)
    ds.global_shuffle(seed=2)        # single process: a local shuffle
    with pytest.raises(NotImplementedError):
        ds.global_shuffle(fleet=object())
    assert sum(len(b["y"]) for b in ds._iter_batches()) == 63
    ds.release_memory()
    assert ds.get_memory_data_size() == 0
    with pytest.raises(ValueError):
        tfluid.DatasetFactory().create_dataset("NoSuchDataset")
    assert not tnative.native_available()


def test_global_shuffle_routes_as_the_reference(tmp_path):
    paths = _write(tmp_path)
    pools = {}
    for name, native in (("ref", jnative), ("port", tnative)):
        feeds = []
        for p in paths:
            f = native.PyDataFeed(_slots(native), 4)
            f.set_filelist([p])
            f.load_into_memory()
            feeds.append(f)
        native.global_shuffle(feeds, seed=7)
        pools[name] = [f._pool for f in feeds]
    assert pools["port"] == pools["ref"]
    rec = pools["port"][0][0]
    assert tnative._route_hash(*rec) == jnative._route_hash(*rec)


def test_packers_equal_the_reference():
    rng = np.random.RandomState(3)
    seqs = [rng.randint(0, 2 ** 40, rng.randint(0, 6)) for _ in range(9)]
    for max_len in (None, 3):
        got = tnative.pack_padded(seqs, pad_value=-1, max_len=max_len)
        want = jnative.pack_padded(seqs, pad_value=-1, max_len=max_len)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    vals = rng.randn(10).astype("float32")
    offs = np.array([0, 2, 2, 7, 10], np.int64)
    for g, w in zip(tnative.pack_padded_csr(vals, offs),
                    jnative.pack_padded_csr(vals, offs)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tnative.pack_padded_csr(vals, np.array([0, 3, 2], np.int64))
