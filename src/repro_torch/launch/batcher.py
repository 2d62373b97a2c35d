"""Continuous-batching serve engine over per-bucket prepared NetworkPlans,
with one CUDA graph per (replica, bucket) on the card.

Conv traffic is ragged (every client sends a different batch size) and
bursty, but FFT convolution is fast on a plan that was made and prepared
for its exact padded shape.  This module is the serving side of
plan-once/execute-many:

  1. A ``BucketPolicy`` fixes a small set of padded batch shapes (powers of
     two up to ``max_batch``, optionally a few image sizes).
  2. At startup the engine plans (``plan_network``) and prepares
     (``NetworkPlan.prepare``) one network per bucket (same-geometry
     buckets dedupe through the shared plan and prepared caches) and, on
     a CUDA device, captures one ``torch.cuda.CUDAGraph`` of
     ``forward(prepared, static_x)`` per (replica, bucket).  The steady
     state replays those graphs: zero re-planning and no launch from the
     host on the hot path but the graph's own, the input copied in and the
     results copied out.  On the CPU the executor is the eager forward.
  3. ``submit`` enqueues requests; ``drain`` packs the FIFO queue into
     bucket batches (a batching window trades latency for occupancy),
     pads to the bucket with zero rows, executes on the next replica
     (round-robin), copies each request's rows out and records its
     latency.
  4. ``report()`` / ``bench_rows()`` give per-bucket p50/p99, occupancy
     (padding waste), queue depth, graph replays and the graphs' memory.

Two reference modes exist only to measure what the bucketing buys:

  ``mode="pad-max"``   one planned shape, every request padded to
                       ``max_batch``, no coalescing (throughput baseline).
  ``mode="replan"``    plan + prepare + capture for each request's exact
                       batch size on the hot path (p99 baseline).

A graph holds the addresses of everything it reads: the static input, the
prepared spectra, the biases its forward closes over, the kernels' tables.
So a weight update re-prepares and recaptures every bucket, and a result
is copied out of the static output, which the next replay of the same
graph overwrites.  A capture that fails raises: the card never falls back
to eager execution.

Over a mesh (``mesh=`` among the plan knobs, the paper's sharded schedules
behind the engine) every rank of the mesh is a process running its own
engine, and the engine is SPMD.  The contract: every rank

  - builds the same engine (the same layers, params, policy and knobs);
  - submits the same requests in the same order;
  - calls ``drain``, ``finish``, ``update_weights`` and ``run_trace`` in
    the same order.

The ranks' clocks never decide a batch: rank 0 of the mesh forms each
batch (which queued requests, or none yet, by its own clock and window)
and sends that word to every rank (``launch.mesh.RankDecisions.decide``:
one fixed-size integer all-reduce along each mesh dim, read once on the
host); every rank takes the named requests from its own queue.  The same
all-reduce carries a digest of each rank's queue (rids, rows and image
sizes in order): a rank whose queue differs from another's has diverged,
and every rank raises the same ``RuntimeError``, so none waits forever
in a collective.
The executed callable is ``forward(prepared, x)`` followed by the counted
gather of a ``DTensor`` output into a plain tensor
(``conv.stages.output_full``), so ``results[rid]`` is the request's rows
of the global output on every rank, as the reference's are.  On a
``cuda`` mesh (NCCL) each bucket's graph is captured over every layer's
collectives and that gather, so a replay runs them; on a ``cpu`` mesh
(gloo) the executor is eager.  Without a mesh nothing is sent.

Not ported yet (they raise ``NotImplementedError``): ``load_plans=`` and
``export_plans`` (ROADMAP Queue 1 item 7, the plan artifacts).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import RankDecisions

# eager passes on a side stream before a capture: they build every lazily
# made device table and load every kernel, which a capture must not do
WARMUP_PASSES = 2


class RequestTooLarge(ValueError):
    """A request exceeds the largest configured bucket."""


# --------------------------------------------------------------------------
# Bucket policy
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """The fixed set of padded batch shapes the engine prepares for.

    ``batch_buckets()`` is powers of two from ``min_batch`` up, with
    ``max_batch`` always included (``max_batch=6`` -> ``(1, 2, 4, 6)``),
    so a request of size b pads to at most 2x its own rows.
    ``image_sizes`` optionally adds a small set of (square) input sizes;
    requests are grouped per image size and never mixed in one batch.
    """
    max_batch: int
    min_batch: int = 1
    image_sizes: tuple = ()

    def __post_init__(self):
        if self.min_batch < 1 or self.max_batch < self.min_batch:
            raise ValueError(
                f"need 1 <= min_batch <= max_batch, got "
                f"min_batch={self.min_batch} max_batch={self.max_batch}")

    def batch_buckets(self) -> tuple:
        out, b = [], 1
        while b < self.max_batch:
            if b >= self.min_batch:
                out.append(b)
            b *= 2
        out.append(self.max_batch)
        return tuple(out)

    def bucket_for(self, n: int, image: Optional[int] = None) -> int:
        """Smallest bucket >= ``n`` rows (``RequestTooLarge`` above
        ``max_batch``); validates ``image`` against ``image_sizes``."""
        if n < 1:
            raise ValueError(f"request batch must be >= 1, got {n}")
        if n > self.max_batch:
            raise RequestTooLarge(
                f"request batch {n} exceeds the largest bucket "
                f"(max_batch={self.max_batch}); split the request or "
                f"raise --max-batch")
        if self.image_sizes and image not in self.image_sizes:
            raise RequestTooLarge(
                f"request image size {image} is not a configured bucket "
                f"(image_sizes={self.image_sizes})")
        for b in self.batch_buckets():
            if b >= n:
                return b
        raise AssertionError("unreachable: max_batch is always a bucket")


# --------------------------------------------------------------------------
# Requests, stats
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Request:
    rid: int
    x: Any
    t_arrival: float
    image: Optional[int] = None

    @property
    def rows(self) -> int:
        return int(self.x.shape[0])


@dataclasses.dataclass
class _BucketStats:
    latencies_s: list = dataclasses.field(default_factory=list)
    service_s: list = dataclasses.field(default_factory=list)
    n_requests: int = 0
    n_batches: int = 0
    real_rows: int = 0
    padded_rows: int = 0


def _percentile(values: Sequence[float], q: float) -> float:
    """p-th percentile (nearest-rank on the sorted sample; no numpy on the
    hot path)."""
    if not values:
        return float("nan")
    s = sorted(values)
    idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return s[idx]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------------------
# Synthetic ragged traffic
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceRequest:
    t: float                      # arrival offset from trace start (s)
    batch: int
    image: Optional[int] = None


def synthetic_trace(*, n_requests: int, max_batch: int, rate_rps: float,
                    seed: int = 0, image_sizes: tuple = ()) -> tuple:
    """Reproducible ragged Poisson trace: exponential inter-arrivals at
    ``rate_rps``, batch sizes uniform on 1..max_batch, optional uniform
    image-size choice (numpy draws in ``repro.launch.batcher``'s order, so
    one seed gives both packages the same trace)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate_rps, 1e-9), n_requests)
    t = 0.0
    out = []
    for g in gaps:
        t += float(g)
        img = int(rng.choice(image_sizes)) if image_sizes else None
        out.append(TraceRequest(t=t, batch=int(rng.integers(1,
                                max_batch + 1)), image=img))
    return tuple(out)


# --------------------------------------------------------------------------
# Executors: one per (replica, bucket)
# --------------------------------------------------------------------------

def _check_rows(parts, x_shape):
    for p in parts:
        if tuple(p.shape[1:]) != tuple(x_shape[1:]):
            raise ValueError(f"request rows {tuple(p.shape[1:])} do not "
                             f"match the bucket's input {tuple(x_shape)}")


class _EagerExecutor:
    """``forward(prepared, x)`` run eagerly on the zero-padded batch: the
    executor on the CPU (a ``cpu`` mesh included)."""
    graph_pool_bytes = None

    def __init__(self, forward, prepared, x_shape, device):
        self._forward, self._prepared = forward, prepared
        self.x_shape, self._device = tuple(x_shape), device
        self.replays = 0

    def warm(self) -> None:
        with torch.inference_mode():
            self._forward(self._prepared, torch.zeros(
                self.x_shape, device=self._device))

    def __call__(self, parts, rows):
        _check_rows(parts, self.x_shape)
        if rows < self.x_shape[0]:
            parts = parts + [parts[0].new_zeros(
                (self.x_shape[0] - rows,) + self.x_shape[1:])]
        x = parts[0] if len(parts) == 1 else torch.cat(parts)
        with torch.inference_mode():
            return self._forward(self._prepared, x)


class _GraphExecutor:
    """One CUDA graph of ``forward(prepared, static_x)``: ``warm`` captures
    it (after eager passes on a side stream), a call copies the batch into
    the static input, zeroes the padded rows and replays.  The output is
    the graph's static tensor, overwritten by the next replay."""

    def __init__(self, forward, prepared, x_shape, device):
        self._forward, self._prepared = forward, prepared
        self.x_shape, self._device = tuple(x_shape), device
        self.graph = None
        self.graph_pool_bytes = None   # device memory the capture reserved
        self.replays = 0

    def warm(self) -> None:
        if self.graph is not None:
            return
        dev = self._device
        # a normal tensor (made outside inference mode), so that a call can
        # copy each batch into it in place
        self.static_x = torch.zeros(self.x_shape, device=dev)
        with torch.inference_mode():
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_PASSES):
                    self._forward(self._prepared, self.static_x)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                # read inside: entering the capture empties the cache
                reserved = torch.cuda.memory_reserved(dev)
                self.static_y = self._forward(self._prepared, self.static_x)
            self.graph_pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph = graph

    def __call__(self, parts, rows):
        _check_rows(parts, self.x_shape)
        self.warm()
        off = 0
        for p in parts:
            self.static_x[off:off + p.shape[0]].copy_(p)
            off += p.shape[0]
        if rows < self.x_shape[0]:
            self.static_x[rows:].zero_()
        self.graph.replay()
        self.replays += 1
        return self.static_y


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------

class ServeEngine:
    """Shape-bucketed dynamic batcher over per-bucket prepared plans.

    Args:
      make_layers: ``make_layers(batch)`` (or ``make_layers(batch,
        image=s)`` when the policy buckets image sizes) returning the
        ``NetworkConv`` sequence for one padded input shape.
      params: layer-name -> kernel tensor mapping (``prepare`` contract;
        biases etc. ride via the ``forward`` closure).
      policy: the ``BucketPolicy``.
      forward: ``forward(prepared_net, x) -> y`` executing one padded
        batch (default: chain the layers in order, no epilogue
        operands).  Captured once per (replica, bucket) on a CUDA device.
      replicas: copies of the prepared state on the engine's device, each
        with its own graphs, round-robin batch dispatch (on a mesh: copies
        on each rank's own device, each holding that rank's slabs; rank
        0's batches keep the round-robin equal on every rank).
      window_s: batching window: a queued request is flushed once it has
        waited this long even if its bucket is not full (0 = flush every
        drain).
      mode: ``"bucketed"`` (the engine) | ``"pad-max"`` | ``"replan"``
        (reference baselines, see module docstring).
      timing: ``"per-batch"`` synchronizes after every bucket execution
        so per-request latency is real; ``"async"`` only synchronizes at
        ``finish()`` (throughput mode: percentiles then measure enqueue,
        not completion).
      weights_version: passed to ``NetworkPlan.prepare`` (a weight update
        is ``update_weights``: one invalidation sweep per bucket, and a
        recapture).
      collect_results: keep each request's output rows (a copy) in
        ``results[rid]`` and where it ran in ``placements[rid]``.
      warm: capture every graph (CPU: run one zero batch per bucket) in
        the constructor, so that every capture is paid before the first
        request.
      clock: the clock latencies are taken on.
      device: where the engine runs (``repro_torch.device.resolve_device``:
        the GPU unless the caller asks for the CPU).
      load_plans: AOT plan artifacts: not ported yet (raises).
      plan_kwargs: shared ``plan_network`` knobs (backend=, mesh=,
        schedule=, overlap=, ...).  A ``mesh`` makes the engine SPMD (the
        module docstring's contract); its device type must be the
        engine's.
    """

    def __init__(self, make_layers: Callable, params: dict, *,
                 policy: BucketPolicy,
                 forward: Optional[Callable] = None,
                 replicas: int = 1, window_s: float = 0.0,
                 mode: str = "bucketed", timing: str = "per-batch",
                 weights_version: Any = 0, collect_results: bool = True,
                 warm: bool = True, clock: Callable = time.monotonic,
                 load_plans: Optional[str] = None, device=None,
                 **plan_kwargs):
        if mode not in ("bucketed", "pad-max", "replan"):
            raise ValueError(f"unknown mode {mode!r}")
        if timing not in ("per-batch", "async"):
            raise ValueError(f"unknown timing {timing!r}")
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if load_plans is not None:
            raise NotImplementedError(
                "load_plans is not yet ported to repro_torch: it needs the "
                "plan artifacts (ROADMAP Queue 1 item 7)")
        t_startup = time.perf_counter()
        self.device = resolve_device(device)
        self.mesh = plan_kwargs.get("mesh")
        if self.mesh is not None and \
                self.mesh.device_type != self.device.type:
            raise ValueError(
                f"a {self.mesh.device_type!r} mesh cannot serve on device "
                f"{str(self.device)!r}: pass the mesh's device type")
        self._ranks = RankDecisions(self.mesh, what="ServeEngine")
        self.policy = policy
        self.mode = mode
        self.timing = timing
        self.replicas = replicas
        self.window_s = float(window_s)
        self.weights_version = weights_version
        self._make_layers = make_layers
        self._forward = _plain_output(
            forward if forward is not None else _chain_forward)
        self._plan_kwargs = dict(plan_kwargs)
        self._clock = clock
        self._collect = collect_results
        self._executor_cls = (_GraphExecutor if self.device.type == "cuda"
                              else _EagerExecutor)

        self._queue: collections.deque = collections.deque()
        self._rid = itertools.count()
        self._stats: dict = collections.OrderedDict()
        self._replica_batches = [0] * replicas
        self._rr = 0
        self._pending: list = []          # async-mode in-flight batches
        self.results: dict = {}
        self.placements: dict = {}        # rid -> (label, replica, row)
        self._t_first_submit: Optional[float] = None
        self._t_last_done: Optional[float] = None
        self._queue_depth_max = 0
        self._n_rejected = 0

        self._params = _replica_params(params, replicas, self.device)

        self.nets: dict = collections.OrderedDict()
        self._exec: list = [dict() for _ in range(replicas)]
        self.plan_source = "live"
        if mode != "replan":
            batches = (policy.batch_buckets() if mode == "bucketed"
                       else (policy.max_batch,))
            for key in self._bucket_keys(batches):
                self._build_bucket(key)
        self.plan_prepare_s = time.perf_counter() - t_startup
        self.capture_s = 0.0
        self._warm_plan_misses: Optional[int] = None
        if warm:
            self.warm()
        self.startup_s = time.perf_counter() - t_startup

    # ---- bucket construction ---------------------------------------------
    def _bucket_keys(self, batches) -> list:
        images = self.policy.image_sizes or (None,)
        return [(b, img) for img in images for b in batches]

    def _layers_for(self, key):
        b, img = key
        if img is None:
            return self._make_layers(b)
        return self._make_layers(b, image=img)

    def _build_bucket(self, key) -> None:
        """Plan + prepare one padded bucket shape on every replica, with an
        executor each (captured by ``warm`` or at its first call).
        Same-geometry buckets dedupe through the shared plan cache
        (identical frozen plans) and the prepared cache (identical
        (plan, kernel) keys per replica)."""
        from repro_torch.conv import autotune
        from repro_torch.conv.netplan import plan_network
        # backend="tuned" measures here, on the engine's device, before
        # any capture
        with autotune.measure_on(self.device):
            net = plan_network(self._layers_for(key), **self._plan_kwargs)
        self.nets[key] = net
        x_shape = net[net.layer_names[0]].x_shape
        for r in range(self.replicas):
            prepared = net.prepare(
                self._params[r], weights_version=self.weights_version)
            self._exec[r][key] = self._executor_cls(
                self._forward, prepared, x_shape, self.device)

    def export_plans(self, path: str) -> str:
        """AOT plan artifacts: not ported yet."""
        raise NotImplementedError(
            "export_plans is not yet ported to repro_torch: it needs the "
            "plan artifacts (ROADMAP Queue 1 item 7)")

    def _executor(self, key, replica):
        ex = self._exec[replica].get(key)
        if ex is None:
            if self.mode != "replan":
                raise AssertionError(f"no executor for bucket {key}")
            # the replan baseline pays plan + prepare + capture here, on
            # the hot path: that cost lands in the request latencies
            self._build_bucket(key)
            ex = self._exec[replica][key]
        return ex

    def warm(self) -> None:
        """Capture every (replica, bucket) graph (CPU: run one zero batch
        each) so that every capture is paid before the first request;
        snapshot the plan cache so ``report()`` can certify zero misses
        after warm-up."""
        from repro_torch.conv.plan import plan_cache_info
        t0 = time.perf_counter()
        for key in self._exec[0]:
            for r in range(self.replicas):
                self._exec[r][key].warm()
        _sync(self.device)
        self.capture_s += time.perf_counter() - t0
        self._warm_plan_misses = plan_cache_info().misses

    def update_weights(self, params: dict, *, weights_version) -> None:
        """Weight update: one invalidation sweep re-preparing every bucket
        on every replica under the new version, and a new capture of each
        (a graph holds the addresses of the old prepared spectra)."""
        self.weights_version = weights_version
        self._params = _replica_params(params, self.replicas, self.device)
        for key in list(self._exec[0]):
            self._build_bucket(key)
        self.warm()

    # ---- queueing ---------------------------------------------------------
    def submit(self, x, *, image: Optional[int] = None) -> int:
        """Enqueue one request (a batch of ``x.shape[0]`` images).
        Raises ``RequestTooLarge`` when no bucket fits it."""
        if image is None and self.policy.image_sizes:
            image = int(x.shape[-1])
        try:
            self.policy.bucket_for(int(x.shape[0]), image)  # validate early
        except RequestTooLarge:
            self._n_rejected += 1
            raise
        now = self._clock()
        if self._t_first_submit is None:
            self._t_first_submit = now
        rid = next(self._rid)
        self._queue.append(_Request(rid=rid, x=x, t_arrival=now,
                                    image=image))
        self._queue_depth_max = max(self._queue_depth_max,
                                    len(self._queue))
        return rid

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def _form_batch(self, *, force: bool) -> Optional[list]:
        """The next batch to run, or None: rank 0's choice
        (``_choose_batch``), which every rank takes from its own queue, or
        a raise on every rank when any rank's queue diverged from rank
        0's.  Without a mesh this process is rank 0 and nothing is
        sent."""
        digest = self._queue_digest()           # before rank 0 takes
        take = self._choose_batch(force=force) if self._ranks.root else None
        rids = [] if take is None else [r.rid for r in take]
        word, agreed = self._ranks.decide(
            [len(rids)] + rids, 1 + self.policy.max_batch, check=digest)
        if not agreed:
            raise RuntimeError(
                "ServeEngine: the ranks' queues diverged from rank 0's; "
                "every rank must submit the same requests in the same order")
        if self._ranks.root:
            return take
        named = word[1:1 + word[0]]
        if not named:
            return None
        queued, gone = {r.rid: r for r in self._queue}, set(named)
        self._queue = collections.deque(
            r for r in self._queue if r.rid not in gone)
        return [queued[rid] for rid in named]

    def _queue_digest(self) -> int:
        """A number that equal queues share (rid, rows and image of each
        queued request, in order; not the arrival times, which are on
        each rank's own clock).  Python hashes ints alike in every
        process."""
        return hash(tuple((r.rid, r.rows, -1 if r.image is None else r.image)
                          for r in self._queue)) & (2 ** 62 - 1)

    def _choose_batch(self, *, force: bool) -> Optional[list]:
        """FIFO-pack the queue head into one bucket batch.  The batch
        launches when it fills ``max_batch`` rows, when the oldest
        request has waited out the batching window, or on ``force``
        (end-of-trace flush).  Baseline modes never coalesce."""
        if not self._queue:
            return None
        head = self._queue[0]
        if self.mode != "bucketed":
            self._queue.popleft()
            return [head]
        take, rows = [], 0
        skipped = collections.deque()
        while self._queue:
            r = self._queue.popleft()
            if r.image != head.image:
                skipped.append(r)
                continue
            if rows + r.rows > self.policy.max_batch:
                skipped.append(r)
                break
            take.append(r)
            rows += r.rows
        while self._queue:
            skipped.append(self._queue.popleft())
        self._queue = skipped
        full = rows >= self.policy.max_batch
        waited = (self._clock() - head.t_arrival) >= self.window_s
        if full or waited or force:
            return take
        # window still open and the bucket is not full: requeue in order
        for r in reversed(take):
            self._queue.appendleft(r)
        return None

    # ---- execution --------------------------------------------------------
    def drain(self, *, force: bool = False) -> int:
        """Run formable batches until the queue empties or the batching
        window holds the remainder back; returns batches executed.
        Draining an empty queue is a no-op returning 0 (on a mesh it still
        takes rank 0's word: another rank's queue may hold requests)."""
        n = 0
        while True:
            reqs = self._form_batch(force=force)
            if reqs is None:
                return n
            self._run_batch(reqs)
            n += 1
            if not self._queue:
                # nothing left to form; on a mesh every rank's queue is
                # as empty as rank 0's, which its word certified
                return n

    def _label(self, bucket: int, image) -> str:
        return f"b{bucket}" if image is None else f"b{bucket}i{image}"

    def _run_batch(self, reqs: list) -> None:
        rows = sum(r.rows for r in reqs)
        image = reqs[0].image
        if self.mode == "pad-max":
            bucket = self.policy.max_batch
        elif self.mode == "replan":
            bucket = rows                      # exact shape, no padding
        else:
            bucket = self.policy.bucket_for(rows, image)
        key = (bucket, image)
        label = self._label(bucket, image)
        replica = self._rr
        self._rr = (self._rr + 1) % self.replicas
        t0 = self._clock()
        ex = self._executor(key, replica)      # replan: builds here
        y = ex([r.x for r in reqs], rows)
        off = 0
        for r in reqs:
            if self._collect:
                # a copy: a graph's output is overwritten by its next replay
                self.results[r.rid] = y[off:off + r.rows].clone()
                self.placements[r.rid] = (label, replica, off)
            off += r.rows
        if self.timing == "per-batch":
            _sync(self.device)
        t1 = self._clock()
        self._replica_batches[replica] += 1
        self._t_last_done = t1
        st = self._stats.setdefault(label, _BucketStats())
        st.n_batches += 1
        st.real_rows += rows
        st.padded_rows += bucket
        st.service_s.append(t1 - t0)
        for r in reqs:
            st.n_requests += 1
            st.latencies_s.append(t1 - r.t_arrival)
        if self.timing == "async":
            self._pending.append(y)

    def finish(self) -> None:
        """Wait until every dispatched batch completed (async mode);
        closes the wall-clock window the throughput is computed over."""
        if self._pending:
            _sync(self.device)
            self._pending = []
            self._t_last_done = self._clock()

    # ---- accounting -------------------------------------------------------
    def _by_bucket(self, attr: str) -> dict:
        """``attr`` of every executor: bucket label -> one per replica."""
        return {self._label(*key): [getattr(self._exec[r][key], attr)
                                    for r in range(self.replicas)]
                for key in self._exec[0]}

    def graph_replays(self) -> dict:
        """Replays per bucket label, one count per replica, for the
        buckets that replayed (CPU: none)."""
        return {label: n for label, n in self._by_bucket("replays").items()
                if any(n)}

    def graph_pool_bytes(self) -> dict:
        """Device memory reserved by each live graph's capture: bucket
        label -> one per replica, for the buckets captured (CPU: none)."""
        return {label: n for label, n in
                self._by_bucket("graph_pool_bytes").items()
                if None not in n}

    def report(self) -> dict:
        """Per-bucket latency percentiles + occupancy and engine-wide
        throughput/queue/cache/graph stats (all from per-request
        accounting; with ``timing="async"`` the percentiles measure
        enqueue, which the report's ``timing`` says)."""
        from repro_torch.conv.plan import plan_cache_info
        buckets = {}
        all_lat: list = []
        total_req = total_real = total_padded = 0
        for label, st in self._stats.items():
            all_lat.extend(st.latencies_s)
            buckets[label] = {
                "p50_us": _percentile(st.latencies_s, 50) * 1e6,
                "p99_us": _percentile(st.latencies_s, 99) * 1e6,
                "service_p50_us": _percentile(st.service_s, 50) * 1e6,
                "n_requests": st.n_requests,
                "n_batches": st.n_batches,
                "occupancy": (st.real_rows / st.padded_rows
                              if st.padded_rows else float("nan")),
            }
            total_req += st.n_requests
            total_real += st.real_rows
            total_padded += st.padded_rows
        wall = None
        if self._t_first_submit is not None and \
                self._t_last_done is not None:
            wall = max(self._t_last_done - self._t_first_submit, 1e-9)
        pools = self.graph_pool_bytes()
        misses_after_warm = None
        if self._warm_plan_misses is not None:
            misses_after_warm = (plan_cache_info().misses
                                 - self._warm_plan_misses)
        return {
            "mode": self.mode,
            "timing": self.timing,
            "replicas": self.replicas,
            "mesh": (None if self.mesh is None else
                     dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))),
            "rank_broadcasts": self._ranks.broadcasts,
            "window_s": self.window_s,
            "buckets": buckets,
            "p50_us": _percentile(all_lat, 50) * 1e6,
            "p99_us": _percentile(all_lat, 99) * 1e6,
            "n_requests": total_req,
            "n_rejected": self._n_rejected,
            "real_rows": total_real,
            "padded_rows": total_padded,
            "occupancy": (total_real / total_padded if total_padded
                          else float("nan")),
            "wall_s": wall,
            "throughput_rows_s": (total_real / wall if wall else None),
            "queue_depth_max": self._queue_depth_max,
            "replica_batches": list(self._replica_batches),
            "plan_cache_misses_after_warmup": misses_after_warm,
            "startup_s": self.startup_s,
            "startup_plan_prepare_s": self.plan_prepare_s,
            "startup_capture_s": self.capture_s,
            "plan_source": self.plan_source,
            "device": str(self.device),
            "executor": ("cuda-graph" if self._executor_cls is _GraphExecutor
                         else "eager"),
            "graph_replays": self.graph_replays(),
            "graph_pool_bytes_by_bucket": pools,
            "graph_pool_bytes": (sum(map(sum, pools.values())) if pools
                                 else None),
        }

    def bucket_report(self) -> dict:
        """Cross-bucket plan-dedupe/cost summary
        (``BucketedNetworkPlan.report`` semantics over this engine's
        buckets, keyed by bucket label)."""
        from repro_torch.conv.netplan import _bucket_report
        nets = {self._label(b, img): net
                for (b, img), net in self.nets.items()}
        return _bucket_report(nets)

    def bench_rows(self, prefix: str = "serve") -> dict:
        """The report in ``BENCH_conv.json`` schema: one row per bucket
        per metric (``serve/<bucket>/{p50,p99,occupancy}``), percentiles
        riding the entry's tolerated ``percentiles`` field."""
        rep = self.report()
        config = {"mode": rep["mode"], "replicas": rep["replicas"],
                  "window_s": rep["window_s"], "timing": rep["timing"]}
        rows = {}
        for label, b in rep["buckets"].items():
            pcts = {"p50": b["p50_us"], "p99": b["p99_us"]}
            meta = dict(config, n_requests=b["n_requests"],
                        n_batches=b["n_batches"])
            rows[f"{prefix}/{label}/p50"] = {
                "us_per_call": b["p50_us"], "percentiles": pcts,
                "config": meta}
            rows[f"{prefix}/{label}/p99"] = {
                "us_per_call": b["p99_us"], "percentiles": pcts,
                "config": meta}
            # occupancy is a 0..1 ratio riding the same schema
            rows[f"{prefix}/{label}/occupancy"] = {
                "us_per_call": b["occupancy"], "config": meta}
        return rows


def _replica_params(params: dict, replicas: int, device) -> list:
    """One param dict per replica on ``device``.  With one replica the
    caller's tensors are used as they are (``to`` returns the same tensor
    when it already lies there), so repeat engine builds over the same
    params dedupe through the prepared cache (keyed ``(plan, id(kernel))``);
    more replicas get copies, so that each owns its own prepared state (on
    a mesh: copies on the rank's own device, each prepared into that
    rank's slabs)."""
    moved = {k: v.to(device) for k, v in params.items()}
    if replicas == 1:
        return [moved]
    return [{k: v.clone() for k, v in moved.items()}
            for _ in range(replicas)]


def _plain_output(forward):
    """``forward`` followed by the counted gather of a sharded network's
    ``DTensor`` output into the plain global tensor: the callable every
    executor runs or captures."""
    from repro_torch.conv.stages import output_full

    def run(prepared, x):
        return output_full(forward(prepared, x))
    return run


def _chain_forward(prepared, x):
    """Default forward: the prepared layers chained in declaration
    order, no epilogue operands (nets whose plans fuse bias/residual
    pass a custom ``forward`` closing over those tensors)."""
    for name in prepared:
        x = prepared[name](x)
    return x


# --------------------------------------------------------------------------
# Trace replay
# --------------------------------------------------------------------------

def run_trace(engine: ServeEngine, trace: Sequence[TraceRequest], *,
              make_input: Callable, realtime: bool = True,
              sleep: Callable = time.sleep) -> dict:
    """Replay a trace through the engine; returns ``engine.report()``.

    ``realtime=True`` sleeps each request to its arrival offset and
    drains between arrivals: latencies reflect the trace's offered rate.
    ``realtime=False`` is the deterministic burst replay: the whole trace
    is submitted up front and then drained, so every strategy faces the
    IDENTICAL backlog (the fair A/B for the pad-max/replan baselines).
    ``make_input(batch, image) -> x``."""
    t0 = engine._clock()
    for tr in trace:
        if realtime:
            dt = tr.t - (engine._clock() - t0)
            if dt > 0:
                sleep(dt)
        engine.submit(make_input(tr.batch, tr.image), image=tr.image)
        if realtime:
            engine.drain()
    engine.drain(force=True)
    engine.finish()
    return engine.report()
