"""Background host->device batch pipeline (counterpart of
procyon_tpu/training/prefetch.py).

A per-stream worker thread pulls host batches (numpy collation happens
inside `stream()`), moves them to the device and keeps up to `depth`
device batches queued, so the next step's collation and transfer overlap
the current step's compute.

The copy (`DeviceCopier`): on a CUDA device each array goes through pinned
host memory with `non_blocking=True` on a side stream, and an event is
recorded after the batch's copies. The consumer (`ready`) makes the
current stream wait on that event before the step uses the batch, and
records the tensors on the current stream so the caching allocator does
not hand their memory back to the side stream while the step reads it.

Exact-resume contract (DistributedSamplerResume semantics,
data/data_config.build_task_streams): the trainer checkpoints a state dict
whose entry for each task must describe the position AFTER the last batch
it actually consumed, not after the last batch the worker prefetched. The
worker therefore snapshots the stream's private state holder after each
pull and enqueues it WITH the batch; the consumer republishes the snapshot
into the trainer-visible holder on pop. The trainer-visible holder has a
single writer (the consuming thread), so checkpoint reads are race-free.
"""

import queue
import threading
from typing import Callable, Dict, Optional

import torch

from procyon_tpu_torch.training.train_step import batch_to_device

_READY = "_copied"   # the event a batch's copies recorded, until `ready`


class DeviceCopier:
    """numpy batch -> tensors on `device` (train_step.batch_to_device,
    which adds the host bound `max_position`). On a CUDA device the copies
    are pinned and non-blocking on a side stream of their own, and the
    batch carries the event that follows them until `ready`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None

    def __call__(self, batch: Dict) -> Dict:
        if self.stream is None:
            return batch_to_device(batch, self.device)
        with torch.cuda.stream(self.stream):
            out = batch_to_device(batch, self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        out[_READY] = event
        return out


def ready(batch: Dict) -> Dict:
    """Make a batch from DeviceCopier safe to use on the current stream
    (a no-op for batches without a pending copy)."""
    event = batch.pop(_READY, None)
    if event is not None:
        current = torch.cuda.current_stream()
        current.wait_event(event)
        for v in batch.values():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                v.record_stream(current)
    return batch


class StreamPrefetcher:
    """Wraps one task stream callable with a depth-bounded device queue."""

    def __init__(self, stream: Callable[[], Dict], *, to_device,
                 task: Optional[str] = None,
                 source_states: Optional[Dict[str, dict]] = None,
                 public_states: Optional[Dict[str, dict]] = None,
                 depth: int = 2):
        self._stream = stream
        self._to_device = to_device
        self._task = task
        self._src = source_states
        self._pub = public_states
        self._q = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = self._stream()
                state = None
                if self._src is not None and self._task is not None:
                    state = self._src.get(self._task)
                item = (self._to_device(batch), state, None)
            except StopIteration:
                item = (None, None, StopIteration())
            except Exception as e:  # surfaced on the consumer's thread
                item = (None, None, e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            if item[2] is not None:
                return

    def __call__(self):
        batch, state, err = self._q.get()
        if err is not None:
            raise err
        if self._pub is not None and self._task is not None \
                and state is not None:
            self._pub[self._task] = state
        return ready(batch)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def wrap_streams(streams: Dict[str, Callable], *, to_device,
                 source_states: Dict[str, dict], depth: int = 2):
    """Wrap every task stream with a StreamPrefetcher.

    Returns (wrapped_streams, public_states, close_fn). Pass
    `public_states` to the Trainer as `stream_states` (it reflects only
    consumed batches) and give the Trainer an identity `to_device`:
    batches arrive already on the device."""
    public_states: Dict[str, dict] = dict(source_states)
    wrapped = {
        task: StreamPrefetcher(
            s, to_device=to_device, task=task,
            source_states=source_states, public_states=public_states,
            depth=depth)
        for task, s in streams.items()
    }

    def close():
        for p in wrapped.values():
            p.close()

    return wrapped, public_states, close
