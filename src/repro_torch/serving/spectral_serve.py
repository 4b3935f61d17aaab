"""Stateful serving sessions over the three-phase decode engine.

Port of ``repro/serving/spectral_serve.py``.  :class:`ServeSession` is the
host-side orchestration layer: it owns a fixed pool of batch slots (one
:class:`~repro_torch.serving.engine.DecodeState`), admits requests into free
slots (prefill → insert), and advances the whole pool with
:meth:`Engine.decode` calls, each of which syncs with the device once.
Every spectral flush reuses the overlap-save plan cached by the first
(``core.fft.plan_log()`` shows zero new plans once the session is warm).

Per-phase wall-clock is accumulated in ``session.phase_s`` (prefill /
insert / generate timed separately, each ending in a device sync).
:func:`sweep_once` is the measurement path of the
``repro_torch.launch.serve`` CLI.
"""

from __future__ import annotations

import collections
import time
from typing import List, Optional

import torch

from repro_torch.core import faults
from repro_torch.serving.engine import DecodeState, Engine

__all__ = ["ServeSession", "sweep_once"]


class ServeSession:
    """A slot pool serving requests through prefill / insert / generate.

    Usage::

        sess = ServeSession(engine, slots=4, max_len=128)
        s0 = sess.submit([5, 17, 3, 20])   # prefill + insert (slot 0)
        s1 = sess.submit(other_prompt)     # joins the running batch
        sess.run(32)                       # 32 steps, all slots
        sess.output(s0)                    # generated ids incl. first token

    Robustness (all opt-in, defaults preserve the original behavior):

    * **deadlines** — ``submit(..., deadline_s=1.0)`` (or a session-wide
      ``default_deadline_s``) stamps the request with a wall-clock budget;
      :meth:`run` reaps expired slots before and after the steps
      (``Engine.release`` freezes them exactly like a natural EOS) and
      counts them under ``expired``.
    * **admission queue** — with ``queue_cap > 0`` a full pool queues up to
      that many requests (FIFO, drained into slots freed by :meth:`run`)
      and returns a negative *ticket*; :meth:`output` resolves tickets once
      admitted.  Beyond the cap — or with the default ``queue_cap=0`` —
      submission raises a typed :class:`~repro_torch.core.faults.ServeError`
      (explicit backpressure, never silent dropping).
    * **prefill retry** — transient prefill failures (the
      ``serve.prefill`` fault site, or any ``RuntimeError``/``OSError``)
      are retried up to ``prefill_retries`` times with exponential backoff
      before the error propagates.
    * :meth:`health` — a host-side snapshot of slots, queue depth and fault
      counters for monitoring (the port has no kernel degradation to
      report: a kernel that fails raises).
    """

    def __init__(
        self,
        engine: Engine,
        *,
        slots: int,
        max_len: int,
        seed: int = 0,
        queue_cap: int = 0,
        default_deadline_s: Optional[float] = None,
        prefill_retries: int = 2,
        retry_backoff_s: float = 0.05,
    ):
        self.engine = engine
        self.slots = slots
        self.max_len = max_len
        self.queue_cap = queue_cap
        self.default_deadline_s = default_deadline_s
        self.prefill_retries = prefill_retries
        self.retry_backoff_s = retry_backoff_s
        self.state: DecodeState = engine.init_state(slots, max_len)
        self._gen = engine.generator(seed + 1)  # prefill sampling stream
        self._out: List[List[int]] = [[] for _ in range(slots)]
        self._live = [False] * slots  # host mirror of per-slot "still emitting"
        self._deadline: List[Optional[float]] = [None] * slots  # monotonic
        self._pending: collections.deque = collections.deque()
        self._next_ticket = -1
        self._ticket_slot: dict = {}  # ticket -> slot once admitted
        self.phase_s = {"prefill": 0.0, "insert": 0.0, "generate": 0.0}
        self.counts = {
            "requests": 0,
            "steps": 0,
            "tokens": 0,
            "rejected": 0,
            "expired": 0,
            "retries": 0,
            "queued": 0,
        }

    def free_slots(self) -> List[int]:
        return [i for i in range(self.slots) if not self._live[i]]

    # -- admission ---------------------------------------------------------

    def submit(
        self,
        prompt,
        slot: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> int:
        """Prefill ``prompt`` (S,) and insert it into a free slot (or the
        given one).  Returns the slot index; the sampled first token is
        already part of :meth:`output`.  With a full pool and
        ``queue_cap > 0`` the request queues instead and a negative ticket
        is returned; beyond the cap a :class:`ServeError` is raised."""
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        if slot is None:
            free = self.free_slots()
            if not free:
                if len(self._pending) < self.queue_cap:
                    ticket = self._next_ticket
                    self._next_ticket -= 1
                    expiry = (
                        time.monotonic() + deadline_s
                        if deadline_s is not None
                        else None
                    )
                    self._pending.append((ticket, prompt, expiry))
                    self.counts["queued"] += 1
                    return ticket
                self.counts["rejected"] += 1
                raise faults.ServeError(
                    "no free slot and admission queue is full; run() until "
                    "a slot finishes or raise queue_cap",
                    site="serve.submit",
                    slots=self.slots,
                    queue_cap=self.queue_cap,
                )
            slot = free[0]
        expiry = time.monotonic() + deadline_s if deadline_s is not None else None
        return self._admit(prompt, slot, expiry)

    def _admit(self, prompt, slot: int, expiry: Optional[float]) -> int:
        prompt = torch.as_tensor(prompt, dtype=torch.long, device=self.engine.model.device).reshape(1, -1)
        if prompt.shape[1] > self.max_len:
            raise faults.ServeError(
                f"prompt length {prompt.shape[1]} > max_len {self.max_len}"
            )

        t0 = time.perf_counter()
        pres = self._prefill_with_retry(prompt, self._gen)
        self._sync()
        t1 = time.perf_counter()
        self.state = self.engine.insert(self.state, pres, slot)
        self._sync()
        t2 = time.perf_counter()

        self.phase_s["prefill"] += t1 - t0
        self.phase_s["insert"] += t2 - t1
        self.counts["requests"] += 1
        first = int(pres.token[0])
        self._out[slot] = [first]
        self._live[slot] = first != self.engine.scfg.eos_id
        self._deadline[slot] = expiry
        self.counts["tokens"] += 1
        return slot

    def _sync(self) -> None:
        if self.state.tokens.is_cuda:
            torch.cuda.synchronize(self.state.tokens.device)

    def _prefill_with_retry(self, prompt, generator):
        """Transient prefill faults get ``prefill_retries`` more attempts
        with exponential backoff; a persistent fault propagates typed."""
        attempts = 1 + max(self.prefill_retries, 0)
        for i in range(attempts):
            try:
                return self.engine.prefill(prompt, max_len=self.max_len, generator=generator)
            except (RuntimeError, OSError):
                if i == attempts - 1:
                    raise
                self.counts["retries"] += 1
                time.sleep(self.retry_backoff_s * (2 ** i))

    def _reap(self) -> None:
        """Release slots whose deadline passed (frozen like a natural EOS)
        and drop expired queued requests."""
        now = time.monotonic()
        for b in range(self.slots):
            dl = self._deadline[b]
            if self._live[b] and dl is not None and now > dl:
                self.state = self.engine.release(self.state, b)
                self._live[b] = False
                self._deadline[b] = None
                self.counts["expired"] += 1
        while self._pending and (
            self._pending[0][2] is not None and now > self._pending[0][2]
        ):
            self._pending.popleft()
            self.counts["expired"] += 1

    def _drain(self) -> None:
        """Admit queued requests into whatever slots are free."""
        while self._pending and self.free_slots():
            ticket, prompt, expiry = self._pending.popleft()
            slot = self.free_slots()[0]
            self._admit(prompt, slot, expiry)
            self._ticket_slot[ticket] = slot

    # -- generation --------------------------------------------------------

    def run(self, steps: int):
        """Advance every slot ``steps`` tokens in one :meth:`Engine.decode`.
        Returns the raw (slots, steps) emission matrix (``eos_id`` filler
        for slots that are done).  Expired slots are reaped and queued
        requests drained both before and after the steps."""
        self._reap()
        self._drain()
        t0 = time.perf_counter()
        self.state, toks = self.engine.decode(self.state, steps)
        host = toks.cpu()  # the run's one sync with the device
        self.phase_s["generate"] += time.perf_counter() - t0
        self.counts["steps"] += steps

        eos = self.engine.scfg.eos_id
        for b in range(self.slots):
            for s in range(steps):
                if not self._live[b]:
                    break
                t = int(host[b, s])
                self._out[b].append(t)
                self.counts["tokens"] += 1
                if t == eos:
                    self._live[b] = False
        self._reap()
        self._drain()
        return toks

    def output(self, handle: int) -> List[int]:
        """Generated ids for a slot index or queue ticket (first sampled
        token onward, EOS included when emitted)."""
        if handle < 0:
            if handle not in self._ticket_slot:
                raise faults.ServeError(
                    f"ticket {handle} is still queued; run() to drain it"
                )
            handle = self._ticket_slot[handle]
        return list(self._out[handle])

    def stats(self) -> dict:
        gen = self.phase_s["generate"]
        return {
            **{f"{k}_s": round(v, 6) for k, v in self.phase_s.items()},
            **self.counts,
            "tok_per_s": round(self.counts["tokens"] / gen, 2) if gen > 0 else None,
        }

    def health(self) -> dict:
        """A monitoring snapshot: slot occupancy, queue depth, session
        counters and fault-injection counters (empty unless faults were
        armed)."""
        live = sum(self._live)
        return {
            "slots": self.slots,
            "live": live,
            "free": self.slots - live,
            "queue_depth": len(self._pending),
            "queue_cap": self.queue_cap,
            "counts": dict(self.counts),
            "fault_counters": faults.fault_counters(),
        }


def sweep_once(
    engine: Engine,
    *,
    batch: int,
    prompt_len: int,
    max_new: int,
    warmup: int = 1,
    seed: int = 0,
) -> dict:
    """One measured serving sweep: ``batch`` requests of ``prompt_len``
    tokens (drawn from ``seed``) admitted one by one (prefill + insert),
    then ``max_new - 1`` decode steps.  ``warmup`` untimed passes absorb
    the kernels' build and the plans.  Returns a flat dict of per-phase
    seconds and throughput — the rows of the CLI's table."""
    max_len = prompt_len + max_new
    prompts = torch.randint(
        4, engine.cfg.vocab_size, (batch, prompt_len), generator=torch.Generator().manual_seed(seed)
    )

    def one_pass():
        sess = ServeSession(engine, slots=batch, max_len=max_len, seed=seed)
        for b in range(batch):
            sess.submit(prompts[b], slot=b)
        if max_new > 1:
            sess.run(max_new - 1)
        return sess

    for _ in range(warmup):
        one_pass()
    sess = one_pass()

    st = sess.stats()
    gen = st["generate_s"]
    total = st["prefill_s"] + st["insert_s"] + gen
    decoded = batch * max(max_new - 1, 0)
    return {
        "batch": batch,
        "prompt_len": prompt_len,
        "max_new": max_new,
        "prefill_s": st["prefill_s"],
        "insert_s": st["insert_s"],
        "generate_s": gen,
        "prefill_s_per_req": round(st["prefill_s"] / batch, 6),
        "insert_s_per_req": round(st["insert_s"] / batch, 6),
        "decode_tok_per_s": round(decoded / gen, 2) if gen > 0 else None,
        "e2e_tok_per_s": round(batch * max_new / total, 2) if total > 0 else None,
    }
