"""Dataset tier: DatasetFactory / InMemoryDataset / QueueDataset.

Counterpart of ``paddle_tpu/fluid/dataset.py`` (reference
python/paddle/fluid/dataset.py: DatasetFactory:30, InMemoryDataset:322
with load_into_memory / local_shuffle / global_shuffle, QueueDataset:747
streaming) over the MultiSlot feed of ``paddle_tpu_torch/native``.
``_iter_batches`` yields executor-ready feed dicts (numpy), so
``Executor.train_from_dataset`` stages batch t+1 on a producer thread
while step t runs (distributed/trainer.py).

Slot mapping: each ``set_use_var`` Variable becomes a slot — int64 vars
are sparse (ids come back CSR and are densified per batch), float vars
are dense with dim = prod(var.shape[1:]).
"""
from __future__ import annotations

from typing import List

import numpy as np


class DatasetFactory:
    """dataset.py:30 — create_dataset("InMemoryDataset"|"QueueDataset")."""

    def create_dataset(self, datafeed_class: str = "QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        raise ValueError(f"unknown dataset class {datafeed_class}")


class DatasetBase:
    def __init__(self):
        self.batch_size = 1
        self.thread_num = 1
        self.filelist: List[str] = []
        self.use_vars = []
        self.pipe_command = "cat"      # accepted for parity; parsing is the
        self._feed = None              # native MultiSlot schema
        self._pad_value = 0

    # -- reference config surface -------------------------------------------
    def set_batch_size(self, batch_size):
        self.batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self.thread_num = int(thread_num)

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    def set_use_var(self, var_list):
        self.use_vars = list(var_list)

    def set_pipe_command(self, pipe_command):
        self.pipe_command = pipe_command

    def set_hdfs_config(self, fs_name, fs_ugi):
        pass

    # -- feed construction --------------------------------------------------
    def _slots(self):
        from ..native import SlotDesc
        slots = []
        for v in self.use_vars:
            dtype = str(getattr(v, "dtype", "float32") or "float32")
            if "int" in dtype:
                slots.append(SlotDesc(v.name, is_dense=False))
            else:
                shape = [d for d in (v.shape or [1])[1:]] or [1]
                dim = int(np.prod([abs(d) for d in shape]))
                slots.append(SlotDesc(v.name, is_dense=True, dim=dim))
        return slots

    def _make_feed(self):
        from ..native import make_data_feed
        feed = make_data_feed(self._slots(), self.batch_size,
                              num_threads=self.thread_num)
        feed.set_filelist(self.filelist)
        return feed

    def _densify(self, batch):
        """CSR sparse slots -> [B, L] padded id matrices (uniform-length
        slots — the CTR norm — reshape without padding)."""
        out = {}
        for name, val in batch.items():
            if isinstance(val, tuple):
                ids, lod = val
                b = len(lod) - 1
                lens = np.diff(lod)
                width = int(lens.max()) if len(lens) else 1
                if b == 0:
                    out[name] = np.empty((0, width), np.int64)
                elif len(lens) and (lens == lens[0]).all():
                    out[name] = ids.reshape(b, int(lens[0]))
                else:
                    from ..native import pack_padded_csr
                    out[name], _ = pack_padded_csr(
                        np.asarray(ids, np.int64),
                        np.asarray(lod, np.int64),
                        pad_value=self._pad_value, max_len=width)
            else:
                out[name] = val
        return out

    def _iter_batches(self):
        raise NotImplementedError


class QueueDataset(DatasetBase):
    """Streaming pass over the filelist (dataset.py:747)."""

    def _iter_batches(self):
        feed = self._make_feed()
        feed.start()
        for batch in feed:
            yield self._densify(batch)


class InMemoryDataset(DatasetBase):
    """load_into_memory + shuffles, then repeatable passes
    (dataset.py:322)."""

    def __init__(self):
        super().__init__()
        self._loaded = False

    def load_into_memory(self):
        self._feed = self._make_feed()
        self._feed.load_into_memory()
        self._loaded = True

    def local_shuffle(self, seed: int = 0):
        if not self._loaded:
            raise RuntimeError("call load_into_memory() first")
        self._feed.local_shuffle(seed)

    def global_shuffle(self, fleet=None, thread_num=0, seed: int = 0):
        """Cross-node shuffle.  Single-process (no fleet) it is the
        reference's local shuffle (data_set.h:118); the RPC record
        exchange across trainers is not ported yet."""
        if not self._loaded:
            raise RuntimeError("call load_into_memory() first")
        if fleet is not None:
            raise NotImplementedError(
                "InMemoryDataset.global_shuffle across trainers needs the "
                "PS RPC plane, which is not ported yet (ROADMAP queue A "
                "item 11)")
        self._feed.local_shuffle(seed)

    def release_memory(self):
        self._feed = None
        self._loaded = False

    def get_memory_data_size(self, fleet=None):
        return self._feed.memory_size if self._feed is not None else 0

    get_shuffle_data_size = get_memory_data_size

    def _iter_batches(self):
        if not self._loaded:
            raise RuntimeError("call load_into_memory() first")
        self._feed.start_from_memory()
        for batch in self._feed:
            yield self._densify(batch)
