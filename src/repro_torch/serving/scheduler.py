"""Request scheduler for the continuous-batching engine (numpy only).

The port's own copy of the JAX package's ``serving/scheduler.py``, cut to
what the single-device engine uses (no lane order).
Host-side bookkeeping only; all device work is in
``repro_torch.serving.engine``.

Request lifecycle::

    submit --> pending (arrival-ordered) --> admitted into a free *lane*
           --> [PREFILLING: chunk cursor advances between decode steps]
           --> DECODING (one token per engine step) --> retired
               (EOS, length limit) --> lane freed for the next request
"""
from __future__ import annotations

import bisect
import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

LANE_PREFILLING = "prefilling"
LANE_DECODING = "decoding"


@dataclass
class Request:
    """One generation request. ``None`` sampling fields inherit the
    engine's ``ServingConfig`` defaults. ``arrival`` is in decode-step
    units: the engine admits a request once its arrival is <= the step
    counter, which makes traces exactly reproducible."""

    uid: int
    tokens: np.ndarray  # (S,) int32 prompt
    max_new_tokens: Optional[int] = None  # includes the prefill-sampled token
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    eos_id: Optional[int] = None
    arrival: float = 0.0
    # modality frontend inputs merged into the prefill batch (numpy
    # arrays or tensors with a leading batch axis of 1): {"frames": ...}
    # for whisper, {"patches": ...} for a VLM
    extra_inputs: Optional[dict] = None

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.tokens).shape[-1])


@dataclass
class StreamEvent:
    """One streamed output token; ``index`` 0 is the token sampled from
    the prefill logits."""

    uid: int
    token: int
    index: int
    finished: bool = False
    finish_reason: str = ""  # "eos" | "length" when finished


@dataclass
class RequestOutput:
    """Collected terminal result for one request (``engine.run``)."""

    uid: int
    prompt_len: int
    tokens: List[int] = field(default_factory=list)
    finish_reason: str = ""
    admitted_at: int = -1
    finished_at: int = -1


@dataclass
class ScheduleStats:
    """Aggregate statistics of one ``serve``/``run`` drive. Times are host
    wall-clock seconds."""

    decode_steps: int = 0
    tokens_emitted: int = 0
    requests_finished: int = 0
    occupancy_sum: int = 0       # sum over steps of active lanes
    admissions: int = 0          # requests admitted, chunked ones included
    admit_seconds: float = 0.0   # prefill (+ chunks) + graft + first token
    shared_admit_seconds: float = 0.0  # of which monolithic prefix-shared
    decode_seconds: float = 0.0  # decode steps incl. sampling
    prefill_chunks: int = 0      # chunk steps run between decode steps
    chunked_admissions: int = 0  # requests admitted in PREFILLING state
    itl_gaps: List[float] = field(default_factory=list)

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(self.decode_steps, 1)

    @property
    def max_itl(self) -> float:
        return max(self.itl_gaps) if self.itl_gaps else 0.0

    def itl_percentile(self, pct: float) -> float:
        """Inter-token latency percentile in seconds (0 if no gaps)."""
        if not self.itl_gaps:
            return 0.0
        return float(np.percentile(np.asarray(self.itl_gaps), pct))

    def slo_miss_rate(self, threshold_s: float) -> float:
        """Fraction of inter-token gaps exceeding ``threshold_s``."""
        if not self.itl_gaps:
            return 0.0
        return sum(1 for g in self.itl_gaps if g > threshold_s) / len(
            self.itl_gaps)


class LaneScheduler:
    """Admit/retire requests into a fixed set of decode lanes. Pending
    requests are arrival-ordered (FIFO among equal arrivals); lanes are
    recycled LIFO. A chunked admission holds its lane in the PREFILLING
    state with a prompt cursor until its final chunk.

    ``lane_order`` overrides the 0..L-1 assignment preference: the mesh
    engine passes an order interleaved across its data shards, so light
    traffic spreads over the data-parallel groups (host-side only)."""

    def __init__(self, max_lanes: int,
                 lane_order: Optional[Sequence[int]] = None):
        assert max_lanes >= 1
        self.max_lanes = max_lanes
        self._pending: List[Request] = []
        self._keys: List[tuple] = []  # (arrival, seq) sort keys
        self._seq = 0
        self._last_key: Optional[tuple] = None
        self._lane_req: List[Optional[Request]] = [None] * max_lanes
        self._lane_state: List[Optional[str]] = [None] * max_lanes
        # chunked-prefill cursors (prompt tokens written / total) by lane;
        # ``_prefill_order`` keeps admission order (oldest chunks first)
        self._prefill_cursor: Dict[int, int] = {}
        self._prefill_target: Dict[int, int] = {}
        self._prefill_order: List[int] = []
        order = (list(range(max_lanes)) if lane_order is None
                 else list(lane_order))
        assert sorted(order) == list(range(max_lanes)), \
            f"lane_order must permute 0..{max_lanes - 1}: {lane_order}"
        # a stack: pop() assigns, so the preferred-first order is reversed
        self._free: List[int] = order[::-1]

    def submit(self, req: Request) -> None:
        key = (float(req.arrival), self._seq)
        i = bisect.bisect(self._keys, key)
        self._keys.insert(i, key)
        self._pending.insert(i, req)
        self._seq += 1

    @property
    def has_pending(self) -> bool:
        return bool(self._pending)

    @property
    def has_work(self) -> bool:
        return bool(self._pending) or self.num_active > 0

    @property
    def num_active(self) -> int:
        return self.max_lanes - len(self._free)

    @property
    def num_decoding(self) -> int:
        return sum(1 for s in self._lane_state if s == LANE_DECODING)

    @property
    def num_prefilling(self) -> int:
        return len(self._prefill_order)

    @property
    def next_arrival(self) -> Optional[float]:
        return self._keys[0][0] if self._keys else None

    def request_in(self, lane: int) -> Request:
        req = self._lane_req[lane]
        assert req is not None, f"lane {lane} is free"
        return req

    def active_lanes(self) -> List[int]:
        return [i for i, r in enumerate(self._lane_req) if r is not None]

    def decoding_lanes(self) -> List[int]:
        return [i for i, s in enumerate(self._lane_state)
                if s == LANE_DECODING]

    def prefilling_lanes(self) -> List[int]:
        """Lanes with an in-flight chunked prefill, in admission order."""
        return list(self._prefill_order)

    def pop_admissible(self, now: float, skip: int = 0) -> Optional[Request]:
        """Pop the (``skip``+1)-th arrived pending request if a lane is
        free (``skip`` > 0: head-of-line lookahead past a request the page
        pool cannot fit yet)."""
        if not self._free or len(self._pending) <= skip:
            return None
        if self._keys[skip][0] > now:
            return None
        self._last_key = self._keys.pop(skip)
        return self._pending.pop(skip)

    def unpop(self, req: Request) -> None:
        """Return the most recently popped request to its exact queue
        position."""
        key = self._last_key
        i = bisect.bisect_left(self._keys, key)
        self._keys.insert(i, key)
        self._pending.insert(i, req)

    def assign(self, req: Request, prefilling: bool = False) -> int:
        lane = self._free.pop()
        self._lane_req[lane] = req
        self._lane_state[lane] = (LANE_PREFILLING if prefilling
                                  else LANE_DECODING)
        if prefilling:
            self._prefill_cursor[lane] = 0
            self._prefill_target[lane] = req.prompt_len
            self._prefill_order.append(lane)
        return lane

    # -- chunked-prefill state machine ---------------------------------
    def begin_prefill(self, lane: int, cursor: int, target: int) -> None:
        """Set a PREFILLING lane's cursor window: ``cursor`` tokens
        already in the cache, ``target`` prompt tokens to reach."""
        assert self._lane_state[lane] == LANE_PREFILLING, lane
        assert 0 <= cursor < target, (cursor, target)
        self._prefill_cursor[lane] = cursor
        self._prefill_target[lane] = target

    def prefill_cursor(self, lane: int) -> int:
        return self._prefill_cursor[lane]

    def prefill_remaining(self, lane: int) -> int:
        return self._prefill_target[lane] - self._prefill_cursor[lane]

    def advance_prefill(self, lane: int, num_tokens: int) -> None:
        """Record ``num_tokens`` prompt tokens written by one chunk."""
        assert self._lane_state[lane] == LANE_PREFILLING, lane
        assert num_tokens >= 1, num_tokens
        cur = self._prefill_cursor[lane] + num_tokens
        assert cur <= self._prefill_target[lane], (cur, lane)
        self._prefill_cursor[lane] = cur

    def mark_decoding(self, lane: int) -> None:
        """PREFILLING -> DECODING (final chunk written, first token
        sampled); the cursor must have reached the prompt length."""
        assert self._lane_state[lane] == LANE_PREFILLING, lane
        assert self._prefill_cursor[lane] == self._prefill_target[lane], lane
        self._lane_state[lane] = LANE_DECODING
        self._prefill_cursor.pop(lane)
        self._prefill_target.pop(lane)
        self._prefill_order.remove(lane)

    def retire(self, lane: int) -> Request:
        req = self._lane_req[lane]
        assert req is not None, f"retiring free lane {lane}"
        assert self._lane_state[lane] == LANE_DECODING, \
            f"retiring lane {lane} mid-prefill"
        self._lane_req[lane] = None
        self._lane_state[lane] = None
        self._free.append(lane)
        return req


class PagePool:
    """Host-side free-list allocator for the paged KV cache: which physical
    pages back each lane's page-table row, page refcounts, and the prefix
    index that finds page-aligned common prompt prefixes (the JAX
    package's ``PagePool``). The device only ever receives finished table
    rows.

    Sharing: only *full* prompt pages are shareable, so a prompt parts
    from a shared prefix at a page boundary and decode never writes a
    shared page (a lane's private tail and decode pages start at the
    parting page). ``make_private`` is the copy-on-write escape for a
    policy that would write inside a shared region.

    Invariants (``tests/test_torch_prefix.py`` holds them against the JAX
    package's pool): a physical page is mapped by several lanes only as a
    registered prefix page; refcount is the number of lanes mapping a
    page; free pages are mapped by no lane; the free list and the mapped
    pages partition the pool.
    """

    def __init__(self, num_pages: int, page_size: int, *,
                 prefix_sharing: bool = True):
        assert num_pages >= 1 and page_size >= 1
        self.num_pages = num_pages
        self.page_size = page_size
        self.prefix_sharing = prefix_sharing
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self.refcount = np.zeros((num_pages,), np.int64)
        self._lane_pages: Dict[int, List[int]] = {}
        # chain digest of the whole token prefix ending at each indexed page
        self._prefix_index: Dict[bytes, int] = {}
        self._page_key: Dict[int, bytes] = {}
        self.peak_in_use = 0
        self.prefix_hits = 0
        self.tokens_saved = 0
        self.util_sum = 0.0
        self.util_samples = 0

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def utilization(self) -> float:
        return self.pages_in_use / self.num_pages

    @property
    def mean_utilization(self) -> float:
        return self.util_sum / max(self.util_samples, 1)

    def sample_utilization(self) -> None:
        self.util_sum += self.utilization
        self.util_samples += 1

    def lane_pages(self, lane: int) -> List[int]:
        return list(self._lane_pages.get(lane, []))

    def can_reserve(self, num_new: int) -> bool:
        return num_new <= len(self._free)

    # -- prefix sharing ------------------------------------------------
    @staticmethod
    def _chain_digests(tokens, num_pages: int, page_size: int
                       ) -> List[bytes]:
        """One rolling digest per full page, ``digest_i = sha1(digest_{i-1}
        || page_i's tokens)``: two prompts share page i only when every
        earlier token matches too, and the prompt is hashed once, not once
        per page."""
        toks = np.asarray(tokens, np.int32)
        out: List[bytes] = []
        d = b"aqua-page-chain"
        for i in range(num_pages):
            page = np.ascontiguousarray(
                toks[i * page_size:(i + 1) * page_size])
            d = hashlib.sha1(d + page.tobytes()).digest()
            out.append(d)
        return out

    def lookup_prefix(self, tokens) -> List[int]:
        """The longest run of indexed full pages matching the prompt's
        page-aligned prefix: their physical ids in logical order (maybe
        empty)."""
        if not self.prefix_sharing:
            return []
        toks = np.asarray(tokens, np.int32)
        shared: List[int] = []
        for key in self._chain_digests(toks, len(toks) // self.page_size,
                                       self.page_size):
            pid = self._prefix_index.get(key)
            if pid is None:
                break
            shared.append(pid)
        return shared

    def register_prefix(self, tokens, pages: Sequence[int],
                        prompt_len: int) -> None:
        """Index the full pages that ``prompt_len`` tokens of a prefilled
        prompt cover. The first writer wins: a chain already indexed keeps
        its physical page."""
        if not self.prefix_sharing:
            return
        digests = self._chain_digests(np.asarray(tokens, np.int32),
                                      prompt_len // self.page_size,
                                      self.page_size)
        for i, key in enumerate(digests):
            if key in self._prefix_index:
                continue
            self._prefix_index[key] = pages[i]
            self._page_key[pages[i]] = key

    # -- reserve / release ----------------------------------------------
    def reserve(self, lane: int, shared_pages: Sequence[int],
                num_new: int) -> Optional[List[int]]:
        """Map ``shared_pages`` (their refcounts raised) and ``num_new``
        fresh pages into ``lane``; returns a snapshot of the lane's pages
        in logical order (``make_private`` may remap the lane later), or
        None (nothing changed) when the free list is short."""
        assert lane not in self._lane_pages, f"lane {lane} already mapped"
        if num_new > len(self._free):
            return None
        pages = list(shared_pages) + [self._free.pop()
                                      for _ in range(num_new)]
        for p in pages:
            self.refcount[p] += 1
        self._lane_pages[lane] = pages
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return list(pages)

    def release(self, lane: int) -> None:
        """Unmap a retired lane: lower its pages' refcounts; a page that
        reaches 0 returns to the free list and leaves the prefix index."""
        for p in self._lane_pages.pop(lane, []):
            self.refcount[p] -= 1
            assert self.refcount[p] >= 0, f"page {p} refcount underflow"
            if self.refcount[p] == 0:
                key = self._page_key.pop(p, None)
                if key is not None:
                    self._prefix_index.pop(key, None)
                self._free.append(p)

    def make_private(self, lane: int, logical_page: int
                     ) -> Optional[Tuple[int, int]]:
        """Copy-on-write: give ``lane`` a private copy of its
        ``logical_page`` if that page is shared (refcount > 1). Returns
        (old, new) physical ids for the device copy
        (``kvcache.paged_copy_page``), or None when the page was private.
        The new page is not indexed (its content will part)."""
        pages = self._lane_pages[lane]
        old = pages[logical_page]
        if self.refcount[old] <= 1:
            return None
        if not self._free:
            raise RuntimeError("page pool exhausted during copy-on-write")
        new = self._free.pop()
        self.refcount[old] -= 1
        self.refcount[new] += 1
        pages[logical_page] = new
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return old, new


def poisson_trace(num_requests: int, *, mean_interarrival: float,
                  prompt_lens: tuple, max_new_tokens: int, vocab_size: int,
                  seed: int = 0, temperature: float = 0.0) -> List[Request]:
    """Synthetic mixed-traffic trace: Poisson arrivals (exponential
    inter-arrival times in decode-step units), prompt lengths cycled from
    ``prompt_lens``, random token prompts. Draws the same numbers as the
    JAX package's ``poisson_trace`` for the same arguments."""
    rng = np.random.default_rng(seed)
    reqs, t = [], 0.0
    for i in range(num_requests):
        t += float(rng.exponential(mean_interarrival))
        s = int(prompt_lens[i % len(prompt_lens)])
        toks = rng.integers(0, vocab_size, size=(s,), dtype=np.int32)
        reqs.append(Request(uid=i, tokens=toks, max_new_tokens=max_new_tokens,
                            temperature=temperature, arrival=t))
    return reqs
