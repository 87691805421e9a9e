"""InferenceProxy — the Network Proxy Daemon (NPD) analogue.

The paper's NPD keeps LLM SDK sockets and threads out of the agent's address
space so a frozen template is safely forkable, and keeps the in-flight LLM
request progressing while the agent is SIGSTOP-quiesced for the dump.

The device analogue: session state must never capture an *in-flight dispatched
computation* (a donated-buffer step in progress) — a template snapshot of
half-dispatched state would be unsound exactly like forking a thread frozen
mid-handshake.  The proxy therefore owns the model-forward dispatch: sessions
submit fixed-size request messages over a bounded queue and receive only
*committed* (fully materialized) results.  ``quiesced()`` is the
StateManager's precondition for a checkpoint — the dispatch-quiescence
analogue of SIGSTOP observation.

The proxy also models the LLM round-trip window (`latency_s`) so benchmarks
can demonstrate inference-masked checkpointing: a checkpoint's dump work
overlaps a pending ``submit()`` exactly as the paper hides CRIU under the
seconds-scale LLM latency.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

__all__ = ["InferenceProxy", "ProxyRequest"]


@dataclass(frozen=True)
class ProxyRequest:
    """Fixed-size request token (the ≤PIPE_BUF FIFO message analogue)."""

    session_id: int
    payload: Any
    submitted_at: float


class InferenceProxy:
    """Owns model-forward dispatch; sessions hold only committed results."""

    def __init__(
        self,
        model_fn: Callable[[Any], Any],
        *,
        latency_s: float = 0.0,
        max_queue: int = 256,
    ):
        self._model_fn = model_fn
        self.latency_s = latency_s
        self._queue: "queue.Queue[Optional[tuple[ProxyRequest, Future]]]" = queue.Queue(
            maxsize=max_queue
        )
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True, name="npd-worker")
        self._stopped = False
        self.completed = 0
        self._worker.start()

    # ----------------------------------------------------------------- api
    def submit(self, session_id: int, payload: Any) -> Future:
        """Enqueue an inference request; returns a Future for the response.

        The session must not stash this Future into checkpointable state —
        the StateManager asserts ``quiesced()`` per session at checkpoint.
        """
        if self._stopped:
            raise RuntimeError("proxy is stopped")
        fut: Future = Future()
        with self._inflight_lock:
            self._inflight += 1
        req = ProxyRequest(session_id=session_id, payload=payload, submitted_at=time.perf_counter())
        self._queue.put((req, fut))
        return fut

    def infer(self, session_id: int, payload: Any) -> Any:
        """Blocking convenience wrapper."""
        return self.submit(session_id, payload).result()

    def quiesced(self) -> bool:
        """True iff no request is in flight (dispatch quiescence)."""
        with self._inflight_lock:
            return self._inflight == 0

    def inflight(self) -> int:
        with self._inflight_lock:
            return self._inflight

    def stop(self) -> None:
        if not self._stopped:
            self._stopped = True
            self._queue.put(None)
            self._worker.join(timeout=10.0)

    # -------------------------------------------------------------- worker
    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            req, fut = item
            try:
                if self.latency_s > 0:
                    time.sleep(self.latency_s)
                result = self._model_fn(req.payload)
                fut.set_result(result)
            except Exception as exc:  # surface to caller, keep worker alive
                fut.set_exception(exc)
            finally:
                with self._inflight_lock:
                    self._inflight -= 1
                self.completed += 1
