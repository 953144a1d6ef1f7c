"""The native input pipeline: the C++ parser of cpp/yt8m_io.cc and its
prefetch, thread and process fan-outs (reference: TF queue-runners with
--num_readers parse threads feeding shuffle_batch_join; the JAX
package's data/pipeline.py, of which this is a copy over its own loader).

The parser fills numpy batch buffers directly (uint8 frames stay uint8
up to the card) with the batch dict of readers.BatchIterator, and a
prefetch thread overlaps parsing with the device. Shuffling shuffles the
file list each epoch (numpy's default_rng(seed)), as the JAX package's
native iterator does; there is no record reservoir.

The library is built at first use with g++ into build/yt8m_tpu_torch_io/
under a name that hashes the source, the flags and this host's CPU (the
build uses -march=native): to a temporary name, renamed into place
under a file lock, so that concurrent processes build it once. Where it
cannot be built, make_batch_iterator falls back to the pure-Python
BatchIterator and logs a warning once; reader_kind names the reader
that runs ("native", "threaded", "processes" or "python").
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import queue
import subprocess
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from yt8m_tpu_torch.data.readers import BatchIterator, ReaderConfig
from yt8m_tpu_torch.data.tfrecord import glob_files

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "cpp", "yt8m_io.cc")
_LIB_DIR = os.path.join(_REPO_ROOT, "build", "yt8m_tpu_torch_io")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

log = logging.getLogger("yt8m_tpu_torch.data")

_lib_handle = None
_lib_lock = threading.Lock()
_warned_fallback = False


def _host_cpu() -> bytes:
    """The CPU's model and flags: a library built with -march=native
    runs only where they match."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [line for line in f.read().splitlines()
                     if line.startswith((b"model name", b"flags"))]
        return b"\n".join(sorted(set(lines)))
    except OSError:
        return os.uname().machine.encode()


def library_path() -> str:
    """Where the library for this source, these flags and this CPU lives."""
    digest = hashlib.sha256()
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(_FLAGS).encode())
    digest.update(_host_cpu())
    return os.path.join(_LIB_DIR, f"libyt8m_io-{digest.hexdigest()[:16]}.so")


def _build_library() -> Optional[str]:
    try:
        lib = library_path()
    except OSError:  # no source in this checkout
        return None
    if os.path.exists(lib):
        return lib
    os.makedirs(_LIB_DIR, exist_ok=True)
    with open(os.path.join(_LIB_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(lib):
                return lib
            tmp = f"{lib}.tmp-{os.getpid()}"
            try:
                subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True,
                               capture_output=True, timeout=120)
                os.replace(tmp, lib)
            except (subprocess.CalledProcessError, FileNotFoundError,
                    subprocess.TimeoutExpired) as e:
                log.warning("building the native reader failed: %s", e)
                return None
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            return lib
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def get_native_lib():
    """The native parser (built if needed), or None where it cannot be."""
    global _lib_handle
    with _lib_lock:
        if _lib_handle is not None:
            return _lib_handle or None
        path = _build_library()
        if path is None:
            _lib_handle = False
            return None
        lib = ctypes.CDLL(path)
        lib.yt8m_reader_new.restype = ctypes.c_void_p
        lib.yt8m_reader_new.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.yt8m_reader_add_file.argtypes = [ctypes.c_void_p,
                                             ctypes.c_char_p]
        lib.yt8m_reader_free.argtypes = [ctypes.c_void_p]
        lib.yt8m_reader_labels_dropped.restype = ctypes.c_longlong
        lib.yt8m_reader_labels_dropped.argtypes = [ctypes.c_void_p]
        lib.yt8m_reader_set_validate.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int]
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.yt8m_reader_next_frame_batch.restype = ctypes.c_int
        lib.yt8m_reader_next_frame_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, u8p, i32p, i32p, i32p,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.yt8m_reader_next_video_batch.restype = ctypes.c_int
        lib.yt8m_reader_next_video_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, f32p, i32p, i32p,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.yt8m_format_topk.restype = ctypes.c_int64
        lib.yt8m_format_topk.argtypes = [
            ctypes.c_char_p, ctypes.c_int, f32p, i32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
        ]
        _lib_handle = lib
        return lib


_ID_STRIDE = 32
# The label budget of a batch: batch * this many label slots, shared by
# its videos (YT-8M averages ~3.4 labels a video, at most ~23). Every
# video's labels are written verbatim; what overflows the budget is
# counted and reported as a warning when the epoch's reader closes.
_LABELS_BUDGET_PER_VIDEO = 64


def _files_of(file_pattern) -> List[str]:
    files = (glob_files(file_pattern) if isinstance(file_pattern, str)
             else list(file_pattern))
    if not files:
        raise IOError(f"no files matched {file_pattern!r}")
    return files


class NativeBatchIterator:
    """Batches from the C++ parser; the batch dict of BatchIterator."""

    def __init__(self, file_pattern, config: ReaderConfig, batch_size: int,
                 num_epochs: Optional[int] = 1, shuffle: bool = False,
                 seed: int = 0, pad_final_batch: bool = True,
                 drop_remainder: bool = False, prefetch: int = 2):
        self.lib = get_native_lib()
        if self.lib is None:
            raise RuntimeError("native yt8m_io library unavailable")
        self.files = _files_of(file_pattern)
        self.config = config
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.shuffle = shuffle
        self.seed = seed
        self.pad_final_batch = pad_final_batch
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch

    def _new_reader(self, files: Sequence[str]):
        cfg = self.config
        names, sizes = cfg.names_and_sizes
        arr_names = (ctypes.c_char_p * len(names))(
            *[n.encode() for n in names])
        arr_sizes = (ctypes.c_int * len(sizes))(*sizes)
        distill = (cfg.distill_feature or "").encode()
        handle = self.lib.yt8m_reader_new(
            arr_names, arr_sizes, len(names), cfg.max_frames,
            1 if cfg.frame_features else 0, distill, cfg.distill_dim)
        self.lib.yt8m_reader_set_validate(handle, int(cfg.validate_crc))
        for f in files:
            self.lib.yt8m_reader_add_file(handle, f.encode())
        return handle

    def _raw_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        cfg = self.config
        bsz = self.batch_size
        labels_cap = bsz * _LABELS_BUDGET_PER_VIDEO
        rng = np.random.default_rng(self.seed)
        has_distill = bool(cfg.distill_feature)
        epoch = 0
        while self.num_epochs is None or epoch < self.num_epochs:
            files = list(self.files)
            if self.shuffle:
                rng.shuffle(files)
            handle = self._new_reader(files)
            try:
                while True:
                    # Padded rows report 0 frames at frame level (as the
                    # Python reader) and 1 at video level.
                    num_frames = (np.zeros((bsz,), np.int32)
                                  if cfg.frame_features
                                  else np.ones((bsz,), np.int32))
                    label_off = np.zeros((bsz + 1,), np.int32)
                    labels_flat = np.zeros((labels_cap,), np.int32)
                    ids_buf = ctypes.create_string_buffer(bsz * _ID_STRIDE)
                    distill_buf = (np.zeros((bsz, cfg.distill_dim),
                                            np.float32)
                                   if has_distill else None)
                    distill_ptr = (
                        distill_buf.ctypes.data_as(ctypes.c_void_p)
                        if distill_buf is not None else None)
                    if cfg.frame_features:
                        # The parser writes the live frames only: the
                        # buffer must arrive zeroed.
                        feats = np.zeros((bsz, cfg.max_frames,
                                          cfg.feature_dim), np.uint8)
                        n = self.lib.yt8m_reader_next_frame_batch(
                            handle, bsz, feats, num_frames, label_off,
                            labels_flat, labels_cap, ids_buf, _ID_STRIDE,
                            distill_ptr)
                    else:
                        feats = np.zeros((bsz, cfg.feature_dim), np.float32)
                        n = self.lib.yt8m_reader_next_video_batch(
                            handle, bsz, feats, label_off, labels_flat,
                            labels_cap, ids_buf, _ID_STRIDE, distill_ptr)
                    if n < 0:
                        raise RuntimeError("native parser error")
                    if n == 0:
                        break
                    yield self._finish_batch(n, feats, num_frames, label_off,
                                             labels_flat, ids_buf,
                                             distill_buf)
            finally:
                dropped = self.lib.yt8m_reader_labels_dropped(handle)
                if dropped:
                    log.warning(
                        "native reader: %d labels exceeded the batch label "
                        "budget (batch_size * %d slots) and were DROPPED — "
                        "ground truth is incomplete for this epoch; raise "
                        "the budget or the batch size", dropped,
                        _LABELS_BUDGET_PER_VIDEO)
                self.lib.yt8m_reader_free(handle)
            epoch += 1

    def _finish_batch(self, n, feats, num_frames, label_off, labels_flat,
                      ids_buf, distill_buf) -> Dict[str, np.ndarray]:
        cfg = self.config
        bsz = self.batch_size
        keep = bsz if (self.pad_final_batch and n < bsz) else n
        dense = np.zeros((keep, cfg.num_classes), np.float32)
        rows = np.repeat(np.arange(n),
                         np.diff(label_off[: n + 1]).clip(min=0))
        cols = labels_flat[: label_off[n]]
        valid = (cols >= 0) & (cols < cfg.num_classes)
        dense[rows[valid], cols[valid]] = 1.0
        mask = np.zeros((keep,), np.float32)
        mask[:n] = 1.0
        raw = ids_buf.raw
        ids: List[bytes] = [
            raw[i * _ID_STRIDE:(i + 1) * _ID_STRIDE].split(b"\x00", 1)[0]
            if i < n else b""
            for i in range(keep)]
        batch = {
            "id": ids,
            "features": feats[:keep],
            "labels": dense,
            "num_frames": num_frames[:keep],
            "batch_mask": mask,
        }
        if distill_buf is not None:
            batch["teacher"] = distill_buf[:keep]
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        gen = self._raw_batches()
        if self.drop_remainder:
            gen = (b for b in gen
                   if int(b["batch_mask"].sum()) == self.batch_size)
        if self.prefetch <= 0:
            yield from gen
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: List[BaseException] = []

        def worker():
            try:
                for item in gen:
                    q.put(item)
            except BaseException as e:  # raised again in the consumer
                error.append(e)
            finally:
                q.put(sentinel)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item


class _FanoutBatchIterator:
    """The parallel readers' common part: the files dealt round robin to
    at most num_workers workers, each a NativeBatchIterator over its
    share. Batches interleave across workers (as shuffle_batch_join's
    did); each video comes once an epoch."""

    def __init__(self, file_pattern, config: ReaderConfig, batch_size: int,
                 num_workers: int = 4, queue_depth: int = 2, **iter_kw):
        self.files = _files_of(file_pattern)
        self.config = config
        self.batch_size = batch_size
        self.num_workers = max(1, min(num_workers, len(self.files)))
        self.queue_depth = queue_depth
        self.iter_kw = iter_kw

    def _file_shards(self):
        shards = [self.files[w::self.num_workers]
                  for w in range(self.num_workers)]
        return [s for s in shards if s]


class ThreadedBatchIterator(_FanoutBatchIterator):
    """--num_readers parse threads. The ctypes call releases the GIL for
    the whole parse, so the threads run in parallel, and batches pass by
    reference through a bounded queue (no pickling)."""

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(
            maxsize=self.queue_depth * self.num_workers)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            # Gives up when the consumer has gone, so that a worker never
            # blocks forever holding its reader open.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(files_w):
            try:
                it = NativeBatchIterator(files_w, self.config,
                                         self.batch_size, prefetch=0,
                                         **self.iter_kw)
                for batch in it:
                    if not put(batch):
                        return
            except BaseException as e:
                put(e)
            finally:
                put(sentinel)

        threads = [threading.Thread(target=worker, args=(files_w,),
                                    daemon=True)
                   for files_w in self._file_shards()]
        for t in threads:
            t.start()
        live = len(threads)
        try:
            while live:
                item = q.get()
                if item is sentinel:
                    live -= 1
                    continue
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def _process_worker(files, config, batch_size, iter_kw, q):
    """A reader process's body (top level, so that spawn can import it)."""
    try:
        for batch in NativeBatchIterator(files, config, batch_size,
                                         prefetch=0, **iter_kw):
            q.put(batch)
    except Exception as e:  # raised again in the consumer
        q.put(e)
    finally:
        q.put(None)


class MultiprocessBatchIterator(_FanoutBatchIterator):
    """--num_readers reader processes (--reader_processes), started with
    spawn: forking a process that holds a CUDA context is unsafe. Batches
    come back pickled through a queue."""

    def __init__(self, *args, queue_depth: int = 4, **kw):
        super().__init__(*args, queue_depth=queue_depth, **kw)

    def __iter__(self):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        q = ctx.Queue(maxsize=self.queue_depth * self.num_workers)
        procs = []
        for files_w in self._file_shards():
            p = ctx.Process(target=_process_worker,
                            args=(files_w, self.config, self.batch_size,
                                  self.iter_kw, q),
                            daemon=True)
            p.start()
            procs.append(p)
        live = len(procs)
        try:
            while live:
                item = q.get()
                if item is None:
                    live -= 1
                    continue
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            for p in procs:
                p.terminate()
                p.join(timeout=5)
            q.close()
            q.join_thread()


def make_batch_iterator(file_pattern, config, batch_size,
                        num_readers: int = 1, reader_processes: bool = False,
                        **kw):
    """The native iterator where the library builds: threads when
    num_readers > 1, processes with reader_processes too; else the
    Python BatchIterator, with a warning the first time."""
    global _warned_fallback
    if get_native_lib() is not None:
        if num_readers > 1 and reader_processes:
            return MultiprocessBatchIterator(
                file_pattern, config, batch_size, num_workers=num_readers,
                **kw)
        if num_readers > 1:
            return ThreadedBatchIterator(
                file_pattern, config, batch_size, num_workers=num_readers,
                **kw)
        return NativeBatchIterator(file_pattern, config, batch_size, **kw)
    if not _warned_fallback:
        log.warning("the native reader could not be built (g++ and %s); "
                    "reading with the pure-Python BatchIterator", _SRC)
        _warned_fallback = True
    kw.pop("prefetch", None)
    return BatchIterator(file_pattern, config, batch_size, **kw)


def reader_kind(it) -> str:
    """The reader behind a batch iterator (unwrapping BoostedIterator)."""
    it = getattr(it, "inner", it)
    for cls, kind in ((MultiprocessBatchIterator, "processes"),
                      (ThreadedBatchIterator, "threaded"),
                      (NativeBatchIterator, "native"),
                      (BatchIterator, "python")):
        if isinstance(it, cls):
            return kind
    return type(it).__name__


def format_lines(video_ids, top_values, top_indices):
    """One CSV line per video: `vid,cls1 p1 cls2 p2 ...` sorted desc.

    Reference inference.py :: format_lines ("%i %g" pairs).
    """
    lines = []
    for vid, vals, idxs in zip(video_ids, top_values, top_indices):
        order = np.argsort(-vals, kind="stable")
        pairs = " ".join(
            "%i %g" % (int(idxs[j]), float(vals[j])) for j in order)
        vid_str = vid.decode() if isinstance(vid, bytes) else str(vid)
        lines.append(f"{vid_str},{pairs}\n")
    return lines


def format_lines_text(video_ids, top_values, top_indices) -> str:
    """format_lines through the native formatter (yt8m_format_topk: the
    same "%i %g" bytes); the Python formatter where the library is
    unavailable. One string."""
    lib = get_native_lib()
    n = len(video_ids)
    if lib is None or n == 0:
        return "".join(format_lines(video_ids, top_values, top_indices))
    ids_arr = np.asarray(
        [v if isinstance(v, bytes) else str(v).encode() for v in video_ids],
        dtype="S")
    stride = ids_arr.dtype.itemsize
    values = np.ascontiguousarray(top_values, np.float32)
    indices = np.ascontiguousarray(top_indices, np.int32)
    k = values.shape[1]
    cap = n * (stride + 2 + 32 * k)
    out = ctypes.create_string_buffer(cap)
    written = lib.yt8m_format_topk(ids_arr.tobytes(), stride, values,
                                   indices, n, k, out, cap)
    if written < 0:  # the cap above is the formatter's worst case
        return "".join(format_lines(video_ids, top_values, top_indices))
    return out.raw[:written].decode()
