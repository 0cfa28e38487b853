"""Event-stream IO for Prophesee formats: `.dat` (Event2D) and `.npy`
(the port's own copy of ``eas_snn_tpu/data/psee_io.py``: host numpy, no
change).

Whole files are memory-mapped once and every access is a vectorized numpy
slice; random access by time is one ``searchsorted`` over the zero-copy
timestamp view (reference: yolox/utils/psee_loader/io/psee_loader.py:
21-246, dat_events_tools.py:24-175, npy_events_tools.py:22-68,
box_loading.py:21-41). A thin stateful facade (`EventStream.load_delta_t`
etc.) keeps the reference's streaming API.

Formats (facts of the Prophesee ecosystem):
  * `.dat`: latin-1 header lines starting with ``% `` (may carry
    ``% Height H`` / ``% Width W``), then 2 bytes [event type u1, event size
    u1], then packed records (t: u4, w: i4) with x = w & 0x3FFF,
    y = (w >> 14) & 0x3FFF, p = (w >> 28) & 1.
  * `.npy`: a standard structured numpy array; field aliases ``ts``->``t``
    and ``confidence``->``class_confidence`` are normalized.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "EVENT_DTYPE",
    "BBOX_DTYPE",
    "EventStream",
    "load_bboxes",
    "write_dat_events",
    "write_bboxes_npy",
]

# decoded event record (matches the reference's _decode_dtype for .dat)
EVENT_DTYPE = np.dtype([("t", "<u4"), ("x", "<u2"), ("y", "<u2"), ("p", "u1")])

# Prophesee bbox record: 40-byte layout with 4 bytes of tail padding after
# 'class_confidence' (box_loading.py:21)
BBOX_DTYPE = np.dtype(
    {
        "names": ["t", "x", "y", "w", "h", "class_id", "track_id", "class_confidence"],
        "formats": ["<i8", "<f4", "<f4", "<f4", "<f4", "<u4", "<u4", "<f4"],
        "offsets": [0, 8, 12, 16, 20, 24, 28, 32],
        "itemsize": 40,
    }
)

_DAT_RAW = np.dtype([("t", "<u4"), ("w", "<i4")])


def _parse_dat_header(f) -> Tuple[int, int, int, Tuple[Optional[int], Optional[int]]]:
    """Return (data_offset, ev_type, ev_size, (H, W)) for a .dat file."""
    f.seek(0)
    height = width = None
    n_comment = 0
    while True:
        bod = f.tell()
        line = f.readline()
        if line[:2] != b"% ":
            break
        words = line.split()
        if len(words) > 2:
            if words[1] == b"Height":
                height = int(words[2])
            elif words[1] == b"Width":
                width = int(words[2])
        n_comment += 1
    f.seek(bod)
    if n_comment > 0:
        ev_type = int(np.frombuffer(f.read(1), np.uint8)[0])
        ev_size = int(np.frombuffer(f.read(1), np.uint8)[0])
        data_offset = bod + 2
    else:  # headerless legacy files: Event2D assumed
        ev_type, ev_size, data_offset = 0, 8, 0
    return data_offset, ev_type, ev_size, (height, width)


def _decode_dat(raw: np.ndarray) -> np.ndarray:
    """Vectorized bit-unpack of Event2D records (x:14 | y:14 | p:1)."""
    out = np.empty(raw.shape[0], EVENT_DTYPE)
    out["t"] = raw["t"]
    w = raw["w"]
    out["x"] = (w & 0x3FFF).astype(np.uint16)
    out["y"] = ((w >> 14) & 0x3FFF).astype(np.uint16)
    out["p"] = ((w >> 28) & 1).astype(np.uint8)
    return out


def _normalize_npy_fields(arr: np.ndarray) -> np.ndarray:
    names = list(arr.dtype.names)
    renames = {"ts": "t", "confidence": "class_confidence"}
    if any(n in renames for n in names):
        arr = arr.view(
            np.dtype(
                {
                    "names": [renames.get(n, n) for n in names],
                    "formats": [arr.dtype.fields[n][0] for n in names],
                    "offsets": [arr.dtype.fields[n][1] for n in names],
                    "itemsize": arr.dtype.itemsize,
                }
            )
        )
    return arr


class EventStream:
    """Memory-mapped random-access reader over a `.dat`/`.npy` event stream.

    Preferred API: ``events_between(t0, t1)`` / ``events_slice(i0, i1)`` —
    stateless, zero-copy until decode. The stateful streaming methods
    (``load_n_events``, ``load_delta_t``, ``seek_time``, ``seek_event``)
    reproduce the reference PSEELoader contract exactly, including
    ``current_time`` bookkeeping (psee_loader.py:105-238).
    """

    def __init__(self, path: str):
        self.path = path
        ext = os.path.splitext(path)[1].lower()
        if ext == ".dat":
            with open(path, "rb") as f:
                offset, ev_type, ev_size, size = _parse_dat_header(f)
            nbytes = os.path.getsize(path) - offset
            self._raw = np.memmap(
                path, dtype=_DAT_RAW, mode="r", offset=offset,
                shape=(nbytes // _DAT_RAW.itemsize,),
            )
            self._decode = _decode_dat
            self._size = size
        elif ext == ".npy":
            self._raw = _normalize_npy_fields(np.load(path, mmap_mode="r"))
            self._decode = lambda a: np.asarray(a)
            self._size = (None, None)
        else:
            raise ValueError(f"unsupported event file extension: {path}")
        self._ts = self._raw["t"]  # zero-copy strided timestamp view
        # streaming facade state
        self._cursor = 0
        self.current_time = 0
        self.done = self.event_count() == 0

    # ---------------- stateless random access ----------------------------
    def event_count(self) -> int:
        return int(self._raw.shape[0])

    def get_size(self) -> Tuple[Optional[int], Optional[int]]:
        """(height, width) from the header, possibly (None, None)."""
        return self._size

    def total_time(self) -> int:
        """Timestamp of the last event in us (0 if empty)."""
        n = self.event_count()
        return int(self._ts[n - 1]) if n else 0

    def first_time(self) -> int:
        return int(self._ts[0]) if self.event_count() else 0

    def time_to_index(self, t: int) -> int:
        """Index of the first event with timestamp >= t (binary search)."""
        return int(np.searchsorted(self._ts, t, side="left"))

    def events_slice(self, i0: int, i1: int) -> np.ndarray:
        """Decoded events [i0, i1)."""
        return self._decode(self._raw[i0:i1])

    def events_between(self, t0: int, t1: int) -> np.ndarray:
        """Decoded events with t0 <= t < t1."""
        return self.events_slice(self.time_to_index(t0), self.time_to_index(t1))

    # ---------------- stateful streaming facade --------------------------
    def reset(self):
        self._cursor = 0
        self.current_time = 0
        self.done = self.event_count() == 0

    def cur_event_count(self) -> int:
        return self._cursor

    def seek_event(self, ev_count: int):
        """(psee_loader.py:172-194 semantics)"""
        n = self.event_count()
        if ev_count <= 0:
            self._cursor, self.current_time = 0, 0
        elif ev_count >= n:
            self._cursor = n
            self.current_time = self.total_time() + 1
        else:
            self._cursor = ev_count
            self.current_time = int(self._ts[ev_count])
        self.done = self._cursor >= n

    def seek_time(self, final_time: int):
        """(psee_loader.py:196-238 semantics, via one searchsorted)"""
        if final_time > self.total_time():
            self._cursor = self.event_count()
            self.current_time = self.total_time() + 1
            self.done = True
            return
        if final_time <= 0:
            self.reset()
            return
        self._cursor = self.time_to_index(final_time)
        self.current_time = int(final_time)
        self.done = self._cursor >= self.event_count()

    def load_n_events(self, ev_count: int) -> np.ndarray:
        """(psee_loader.py:105-126 semantics)"""
        n = self.event_count()
        i0 = self._cursor
        i1 = min(i0 + ev_count, n)
        out = self.events_slice(i0, i1)
        self._cursor = i1
        if i1 >= n:
            self.done = True
            self.current_time = (int(self._ts[n - 1]) + 1) if n else 0
        else:
            self.current_time = int(self._ts[i1])
        return out

    def load_delta_t(self, delta_t: int) -> np.ndarray:
        """(psee_loader.py:128-170 semantics)"""
        if delta_t < 1:
            raise ValueError("load_delta_t(): delta_t must be at least 1 us")
        n = self.event_count()
        if self.done or self._cursor >= n:
            self.done = True
            return np.empty((0,), EVENT_DTYPE)
        final_time = self.current_time + delta_t
        i1 = int(np.searchsorted(self._ts, final_time, side="left"))
        i1 = max(i1, self._cursor)
        out = self.events_slice(self._cursor, i1)
        self._cursor = i1
        last_t = self.total_time()
        self.current_time = final_time if final_time <= last_t else last_t + 1
        self.done = self._cursor >= n
        return out

    def __repr__(self) -> str:
        return (
            f"EventStream({self.path!r}, events={self.event_count()}, "
            f"duration={self.total_time() * 1e-6:.3f}s)"
        )


def load_bboxes(path: str) -> np.ndarray:
    """Load a Prophesee `_bbox.npy` file, normalizing legacy field names
    (ts->t, confidence->class_confidence; box_loading.py:24-41)."""
    boxes = np.load(path)
    if boxes.dtype.names is None:
        raise ValueError(f"{path} is not a structured bbox array")
    if "t" in boxes.dtype.names and "class_confidence" in boxes.dtype.names:
        return boxes
    new = np.zeros((len(boxes),), BBOX_DTYPE)
    for name in boxes.dtype.names:
        if name == "ts":
            new["t"] = boxes[name]
        elif name == "confidence":
            new["class_confidence"] = boxes[name]
        elif name in BBOX_DTYPE.names:
            new[name] = boxes[name]
    return new


def write_dat_events(
    path: str,
    t: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    p: np.ndarray,
    height: int = 240,
    width: int = 304,
):
    """Write a `.dat` Event2D file (used by tests to build synthetic
    streams byte-compatible with the real format)."""
    t = np.asarray(t, np.uint32)
    order = np.argsort(t, kind="stable")
    t, x, y, p = t[order], np.asarray(x)[order], np.asarray(y)[order], np.asarray(p)[order]
    raw = np.empty(t.shape[0], _DAT_RAW)
    raw["t"] = t
    raw["w"] = (
        (np.asarray(x, np.int64) & 0x3FFF)
        | ((np.asarray(y, np.int64) & 0x3FFF) << 14)
        | ((np.asarray(p, np.int64) & 1) << 28)
    ).astype(np.int32)
    with open(path, "wb") as f:
        f.write(b"% Data file\n")
        f.write(f"% Height {height}\n".encode())
        f.write(f"% Width {width}\n".encode())
        f.write(np.uint8(0).tobytes())  # event type: Event2D
        f.write(np.uint8(8).tobytes())  # event size
        f.write(raw.tobytes())


def write_bboxes_npy(path: str, rows) -> np.ndarray:
    """Write bbox annotations; rows = iterable of
    (t, x, y, w, h, class_id, track_id, confidence)."""
    arr = np.zeros(len(rows), BBOX_DTYPE)
    for i, r in enumerate(rows):
        (
            arr[i]["t"], arr[i]["x"], arr[i]["y"], arr[i]["w"], arr[i]["h"],
            arr[i]["class_id"], arr[i]["track_id"], arr[i]["class_confidence"],
        ) = r
    np.save(path, arr)
    return arr
