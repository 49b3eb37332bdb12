"""Asynchronous checkpoint writer: the npz write off the training loop.

Counterpart of zeroshotvideoclassification_tpu/train/async_ckpt.py. A
synchronous save of the train state (float32 parameters and both Adam
moments, about 380 MB for r2plus1d_18) blocks the step loop for the whole
disk write. Here the trainer brings the state to host numpy on its own
thread (checkpoint.host_state, which waits for the device) and hands it to
one writer thread, which runs save_checkpoint's atomic temporary write and
rename while the next epoch's steps run.

Semantics:
  * one writer thread, writes execute in submission order (no torn order);
  * atomicity comes from save_checkpoint's os.replace — a reader (e.g.
    --resume auto of a later job) never sees a partial file;
  * submit() never blocks on IO; wait() drains the queue (the trainer calls
    it before it returns and before reading back its own files);
  * a failed write re-raises on the NEXT submit()/wait(), so disk-full or
    permission errors are not silently swallowed.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

from zeroshotvideoclassification_tpu_torch.train.checkpoint import (
    save_checkpoint,
)


class AsyncCheckpointer:
    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._error: Optional[BaseException] = None
        # pending-write COUNT under a condition, not an Event: with an Event
        # there is a window between the worker's queue-empty check and
        # idle.set() where a concurrent submit() can clear-then-enqueue,
        # after which the worker sets idle stale — wait() would return with
        # a write still queued (and a daemon thread can die at interpreter
        # exit before it lands).
        self._cond = threading.Condition()
        self._pending = 0
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                save_checkpoint(*item)
            except BaseException as e:  # surfaced on next submit()/wait()
                self._error = e
            finally:
                with self._cond:
                    self._pending -= 1
                    if self._pending == 0:
                        self._cond.notify_all()

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, path: str, train_state, epoch: int, accuracy: float,
               config_json: Optional[str] = None) -> None:
        """Queue one atomic checkpoint write. `train_state` must already be
        host numpy (checkpoint.host_state(state)): the caller owns the
        device-to-host copy, so that the state written is the state of the
        moment of the call."""
        self._raise_pending()
        if self._stop:
            raise RuntimeError("checkpointer is closed")
        with self._cond:
            self._pending += 1
        self._q.put((path, train_state, epoch, accuracy, config_json))

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until all queued writes hit disk; re-raise any write error.

        Raises TimeoutError if writes are still pending when `timeout`
        expires — returning silently would let the caller exit believing
        the checkpoint is durable while the daemon writer dies mid-queue."""
        with self._cond:
            drained = self._cond.wait_for(
                lambda: self._pending == 0, timeout=timeout)
        self._raise_pending()
        if not drained:
            raise TimeoutError(
                f"checkpoint writes still pending after {timeout}s "
                "(disk stalled?)")

    def close(self, timeout: float = 60.0) -> None:
        self.wait(timeout=timeout)
        self._stop = True
        self._q.put(None)
        self._worker.join(timeout=timeout)
        if self._worker.is_alive():
            raise TimeoutError(
                f"checkpoint writer did not exit within {timeout}s")
        self._raise_pending()
