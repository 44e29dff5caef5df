"""Serving: dynamic batching of concurrent requests, and a lane of live
streams.

The counterpart of the JAX package's `pipeline/server.py` on one device:

  * `ServingEngine`: submit() enqueues a request and returns a
    concurrent.futures.Future. A worker thread waits up to `max_wait_ms`
    for stragglers, groups up to `max_batch` requests, validates each on
    its own, partitions the group by text bucket and dispatches each part
    through `Synthesizer.synthesize_batch_dispatch` (one batch of the mel
    phase and the vocoder). Dispatch and read-back are split: group N is
    validated, its texts prepared and its durations enqueued while group
    N-1's mel phase and vocoder still run on the device, and group N-1 is
    read back after that; group N's duration read-back waits for group
    N-1's device work (one stream), so their device work does not overlap.
    Long-form requests (text past INTERACTIVE_TEXT_CAP, or items past the
    15000-frame bucket) go through `synthesize_long` one at a time,
    sharded over a sequence-parallel mesh when the engine has one
    (`sp_mesh`, `dist/sp.py`).
  * `StreamingLane`: live streams multiplexed over one
    `MultiStreamSynthesizer`, one dispatch per tick for every stream;
    submit() returns a handle that yields waveform chunks.

Both workers are threads of their own. Inference mode and the current CUDA
device are per thread in PyTorch, so each worker enters them itself.

The engine's worker marks its steps with spans (`utils/observability.py`,
recorded while the recorder is on): `engine.collect`, `engine.validate`,
`engine.dispatch` (one per `synthesize_batch_dispatch` call) and
`engine.finalize`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from concurrent import futures
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch

from jyutvoice_tpu_torch.pipeline import buckets as bkt
from jyutvoice_tpu_torch.pipeline.streaming import MultiStreamSynthesizer
from jyutvoice_tpu_torch.pipeline.synthesize import (
    NoiseBufferExceeded,
    OverLongBatchItems,
    check_request,
)
from jyutvoice_tpu_torch.utils.observability import span


def _worker_context(device: torch.device) -> contextlib.ExitStack:
    """Inference mode and, on CUDA, the synthesizer's device as the current
    one: both are thread-local, so a worker thread sets them itself."""
    stack = contextlib.ExitStack()
    stack.enter_context(torch.inference_mode())
    if device.type == "cuda":
        stack.enter_context(torch.cuda.device(device))
    return stack


def _pinned_allocs(device: torch.device) -> int:
    """Pinned host blocks that the CUDA caching host allocator has allocated
    so far in this process: the buffers it could not reuse, each a
    cudaHostAlloc. 0 off CUDA."""
    if device.type != "cuda":
        return 0
    return int(torch.cuda.host_memory_stats()["num_host_alloc"])


@dataclasses.dataclass
class ServeStats:
    requests: int = 0
    batches: int = 0  # finalize rounds (one per collected group)
    dispatches: int = 0  # device dispatches (text-bucket and split partitions)
    errors: int = 0
    total_latency_s: float = 0.0  # submit -> result
    # pinned host blocks allocated across dispatches and finalizes (the
    # allocator's count is the process's: another thread's allocations in
    # the meantime count too)
    pinned_allocs: int = 0
    batch_sizes: Optional[List[int]] = None

    def __post_init__(self):
        if self.batch_sizes is None:
            self.batch_sizes = []

    @property
    def mean_batch(self) -> float:
        return float(np.mean(self.batch_sizes)) if self.batch_sizes else 0.0

    @property
    def mean_latency_ms(self) -> float:
        return 1000.0 * self.total_latency_s / self.requests if self.requests else 0.0


class _Request:
    __slots__ = ("item", "future", "t_submit")

    def __init__(self, item: dict):
        self.item = item
        self.future: Future = Future()
        self.t_submit = time.perf_counter()


class ServingEngine:
    """Coalesces concurrent synthesis requests into batched device calls.

    n_timesteps / length_scale / return_mel / pcm16 are engine-level; run
    separate engines for different sampling settings. With pcm16 the
    results carry int16 waveforms. split_dispatch_at bounds one dispatch's
    batch: larger groups go out as back-to-back dispatches of that size.
    long_attention is the long-form attention mode ("auto", "banded" or
    "exact") of the requests sent through synthesize_long. A long-form
    request holds the device for its whole solve, so it delays requests
    that arrive with it; serve such traffic from a separate engine, or
    stream it through a StreamingLane. sp_mesh (`dist/sp.py::make_sp_mesh`,
    rank 0 on the synthesizer's device) shards each long solve over the
    mesh's "seq" ranks with sp_attention ("scores", "ring" or "banded"),
    shortening the long request and the window it holds the device;
    long_attention is then not used (`cli.serve --sp-devices N`).
    """

    def __init__(
        self,
        synthesizer,
        max_batch: int = 8,
        max_wait_ms: float = 20.0,
        n_timesteps: int = 10,
        length_scale: float = 1.0,
        return_mel: bool = False,
        pcm16: bool = False,
        split_dispatch_at: int = 8,
        sp_mesh=None,
        sp_attention: str = "scores",
        long_attention: str = "auto",
    ):
        self.synth = synthesizer
        self.max_batch = max_batch
        self.split_dispatch_at = split_dispatch_at
        self.sp_mesh = sp_mesh
        self.sp_attention = sp_attention
        self.long_attention = long_attention
        self.max_wait_s = max_wait_ms / 1000.0
        self.n_timesteps = n_timesteps
        self.length_scale = length_scale
        self.return_mel = return_mel
        self.pcm16 = pcm16
        self.stats = ServeStats()
        self._q: "queue.SimpleQueue[Optional[_Request]]" = queue.SimpleQueue()
        self._stop = threading.Event()
        # guards submit()'s stop check and enqueue against close(): without
        # it a submit racing close() could enqueue after the drain and leave
        # its Future unresolved
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, name="jyutvoice-serving",
                                        daemon=True)
        self._worker.start()

    # -- client API ----------------------------------------------------------

    def submit(
        self,
        text: str,
        lang: str = "yue",
        phone: Optional[str] = None,
        spk_embed: Optional[np.ndarray] = None,
        prompt_feat: Optional[np.ndarray] = None,
        prompt_h: Optional[np.ndarray] = None,
    ) -> Future:
        """Enqueue one utterance; the Future resolves to a SynthesisResult."""
        req = _Request(dict(text=text, lang=lang, phone=phone, spk_embed=spk_embed,
                            prompt_feat=prompt_feat, prompt_h=prompt_h))
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("engine is closed")
            self._q.put(req)
        return req.future

    def synthesize(self, *args, **kwargs):
        """Blocking convenience wrapper around submit()."""
        return self.submit(*args, **kwargs).result()

    def close(self, timeout: float = 30.0) -> None:
        """Stop taking requests, let the worker finish its group, and fail
        whatever is still queued."""
        with self._submit_lock:
            self._stop.set()
            self._q.put(None)  # wake the worker
        self._worker.join(timeout)
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not None and not req.future.done():
                self._resolve(req.future, req.future.set_exception,
                              RuntimeError("engine is closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker --------------------------------------------------------------

    def _collect(self) -> List[_Request]:
        """Block for the first request, then gather stragglers for one
        window."""
        first = self._q.get()
        if first is None:
            return []
        group = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(group) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                req = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if req is None:
                self._q.put(None)  # signal shutdown again after this group
                break
            group.append(req)
        return group

    @staticmethod
    def _resolve(future, set_fn, value) -> None:
        """Resolve a future that a client may cancel at the same moment: an
        InvalidStateError here would kill the worker thread."""
        if future.cancelled():
            return
        try:
            set_fn(value)
        except futures.InvalidStateError:
            pass  # cancelled (or resolved) between the check and the set

    def _fail(self, group: List[_Request], e: Exception) -> None:
        for req in group:
            self._resolve(req.future, req.future.set_exception, e)
        self.stats.errors += len(group)

    def _validate(self, group: List[_Request]) -> List[_Request]:
        """The text front end and the per-item checks, request by request,
        failing only the bad ones: raised inside the batched dispatch, one
        malformed request would fail every request batched with it. The
        front end's output is kept on the item ("_prepped")."""
        ok = []
        for req in group:
            try:
                it = req.item
                check_request(self.synth.cfg, it.get("spk_embed"), it.get("prompt_feat"),
                              it.get("prompt_h"))
                it["_prepped"] = self.synth.prepare_text(it["text"], it.get("lang", "yue"),
                                                         it.get("phone"))
                ok.append(req)
            except Exception as e:  # noqa: BLE001 — one request's failure is its own
                self._fail([req], e)
        return ok

    @contextlib.contextmanager
    def _counting_pinned(self):
        """Add the pinned host blocks allocated in the block to the stats."""
        n0 = _pinned_allocs(self.synth.device)
        try:
            yield
        finally:
            self.stats.pinned_allocs += _pinned_allocs(self.synth.device) - n0

    def _dispatch_sub(self, sub: List[_Request], finals, ok_group, defer_long) -> None:
        """Dispatch one part of a group, failing only the requests at fault:
        items past the batch mel table go to `defer_long` (served by
        synthesize_long, which has no cap and grafts prompts) and the rest
        is dispatched again; a group past the noise buffer (a property of
        the group: its mel bucket is the longest item's) is split into its
        prompted and plain items, and fails only if a prompted group passes
        it on its own bucket."""
        work = [list(sub)]
        while work:
            attempt = work.pop()
            if not attempt:
                continue
            try:
                with span("engine.dispatch"), self._counting_pinned():
                    finals.append(self.synth.synthesize_batch_dispatch(
                        [r.item for r in attempt], n_timesteps=self.n_timesteps,
                        length_scale=self.length_scale, return_mel=self.return_mel,
                        pcm16=self.pcm16,
                    ))
                ok_group.extend(attempt)
                self.stats.dispatches += 1
            except OverLongBatchItems as e:
                culprit_ids = {id(attempt[i]) for i in e.indices}
                defer_long.extend(r for r in attempt if id(r) in culprit_ids)
                work.append([r for r in attempt if id(r) not in culprit_ids])
            except NoiseBufferExceeded as e:
                prompts = [r for r in attempt if r.item.get("prompt_feat") is not None]
                rest = [r for r in attempt if r.item.get("prompt_feat") is None]
                if prompts and rest:
                    work.append(rest)
                    work.append(prompts)
                else:
                    self._fail(attempt, e)
            except Exception as e:  # noqa: BLE001
                self._fail(attempt, e)

    def _finalize(self, group: List[_Request], finalize) -> None:
        with span("engine.finalize"):
            try:
                with self._counting_pinned():
                    results = finalize()
            except Exception as e:  # noqa: BLE001 — failed read-back: fail the group
                self._fail(group, e)
                return
            t_end = time.perf_counter()
            self.stats.batches += 1
            self.stats.batch_sizes.append(len(group))
            for req, res in zip(group, results):
                self.stats.requests += 1
                self.stats.total_latency_s += t_end - req.t_submit
                self._resolve(req.future, req.future.set_result, res)

    def _partition(self, group: List[_Request]) -> List[List[_Request]]:
        """Parts of at most split_dispatch_at requests whose text lengths
        stay within 2x of the part's shortest: the mel bucket is the longest
        item's, so one long text would otherwise pad every short one to its
        bucket."""
        if not group:
            return []
        group = sorted(group, key=lambda r: r.item["_prepped"][2])
        parts, cur = [], [group[0]]
        for r in group[1:]:
            if r.item["_prepped"][2] > 2 * cur[0].item["_prepped"][2]:
                parts.append(cur)
                cur = [r]
            else:
                cur.append(r)
        parts.append(cur)
        sd = self.split_dispatch_at
        return [part[i : i + sd] for part in parts for i in range(0, len(part), sd)]

    def _serve_long(self, req: _Request) -> None:
        it = req.item
        try:
            res = self.synth.synthesize_long(
                it["text"], lang=it.get("lang", "yue"), phone=it.get("phone"),
                spk_embed=it.get("spk_embed"), prompt_feat=it.get("prompt_feat"),
                prompt_h=it.get("prompt_h"), mesh=self.sp_mesh,
                sp_attention=self.sp_attention,
                attention=self.long_attention if self.sp_mesh is None else "auto",
                n_timesteps=self.n_timesteps, length_scale=self.length_scale,
                pcm16=self.pcm16, dequantize=False, return_mel=self.return_mel,
                prepped=it["_prepped"],
            )
        except Exception as e:  # noqa: BLE001
            self._fail([req], e)
            return
        self.stats.dispatches += 1
        self._finalize([req], lambda: [res])

    def _run(self) -> None:
        with _worker_context(self.synth.device):
            self._serve()

    def _serve(self) -> None:
        # double-buffered: group N is dispatched before group N-1's results
        # are read back, so the host's text front end and validation of
        # group N overlap group N-1's device work (N's duration read-back
        # then waits for it)
        pending = None  # (group, finalize)
        while not self._stop.is_set():
            if pending is not None and self._q.empty():
                self._finalize(*pending)
                pending = None
                continue
            with span("engine.collect"):
                group = self._collect()
            if not group:
                if pending is not None:
                    self._finalize(*pending)
                    pending = None
                continue
            with span("engine.validate"):
                group = self._validate(group)
            if not group:
                continue
            # long-form texts go through synthesize_long one by one (two of
            # them batched would both fail at the mel bucket table)
            long_reqs = [r for r in group if r.item["_prepped"][2] > bkt.INTERACTIVE_TEXT_CAP]
            short = [r for r in group if r.item["_prepped"][2] <= bkt.INTERACTIVE_TEXT_CAP]
            finals, ok_group = [], []
            for sub in self._partition(short):
                # items the dispatcher finds past the mel table join long_reqs
                self._dispatch_sub(sub, finals, ok_group, long_reqs)
            # this group's batches are enqueued; now release the previous
            # group, then run the long solves, each resolving its own request
            if pending is not None:
                self._finalize(*pending)
                pending = None
            for req in long_reqs:
                self._serve_long(req)
            if finals:
                def finalize(fins=tuple(finals)):
                    return [res for f in fins for res in f()]

                pending = (ok_group, finalize)
        if pending is not None:
            self._finalize(*pending)


class _StreamHandle:
    """Client side of a streaming request: iterate to receive waveform
    chunks. cancel() tells the lane to stop decoding the stream: its slot
    frees at the worker's next pass and no more chunks are queued."""

    _DONE = object()

    def __init__(self):
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._cancelled = threading.Event()

    def cancel(self) -> None:
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def __iter__(self):
        return self.iter_timeout(None)

    def iter_timeout(self, timeout=None):
        """Chunk iterator whose wait for each chunk is bounded: a wedged or
        dead lane worker raises TimeoutError instead of blocking the
        consumer forever."""
        while True:
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"no stream chunk within {timeout} s (lane wedged or overloaded)"
                ) from None
            if item is _StreamHandle._DONE:
                return
            if isinstance(item, Exception):
                raise item
            yield item


class StreamingLane:
    """Live streams that share one dispatch and one read-back per tick
    (`MultiStreamSynthesizer`, on the synthesizer's own models and device).

    submit() returns an iterable of 24 kHz waveform chunks (int16 with
    pcm16). Streams beyond `max_streams` wait for a free slot. Cloning
    streams need a lane built with prompt_frames > 0 (a PROMPT_BUCKETS
    value); plain streams share such a lane with their prompt region
    masked, but every tick then decodes the prompt-extended segment, so keep
    prompt_frames=0 unless cloning streams are served.
    """

    def __init__(
        self,
        synthesizer,
        max_streams: int = 4,
        chunk_frames: int = 100,
        n_timesteps: int = 10,
        pcm16: bool = False,
        prompt_frames: int = 0,
    ):
        self.synth = synthesizer
        self.chunk_frames = chunk_frames
        self.n_timesteps = n_timesteps
        self.prompt_frames = prompt_frames
        # samples per emitted mel frame: the vocoder's total upsample, the
        # unit of the streams' chunk slicing
        self._spf = synthesizer.cfg.hift.total_upsample
        self._ms = MultiStreamSynthesizer(
            synthesizer.cfg, synthesizer.tts, synthesizer.hift, max_sessions=max_streams,
            chunk_frames=chunk_frames, prompt_frames=prompt_frames,
            n_timesteps=n_timesteps, pcm16=pcm16, device=synthesizer.device,
        )
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._handles = {}  # sid -> (_StreamHandle, samples still to emit)
        self._stop = threading.Event()
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, name="jyutvoice-streaming",
                                        daemon=True)
        self._worker.start()

    @property
    def dispatches(self) -> int:
        """Ticks that launched work so far (one chunk for every live stream)."""
        return self._ms.dispatches

    def submit(
        self,
        text: str,
        lang: str = "yue",
        phone: Optional[str] = None,
        spk_embed: Optional[np.ndarray] = None,
        length_scale: float = 1.0,
        prompt_feat: Optional[np.ndarray] = None,
        prompt_h: Optional[np.ndarray] = None,
    ) -> _StreamHandle:
        """Queue one stream. The request is checked here, in the caller's
        thread, so its error comes at submit time, not inside a tick."""
        check_request(self.synth.cfg, spk_embed, prompt_feat, prompt_h)
        if prompt_feat is not None:
            if self.prompt_frames == 0:
                raise ValueError(
                    "this streaming lane was built without prompt capacity (prompt_frames=0);"
                    " rebuild it with prompt_frames set to a PROMPT_BUCKETS value to stream"
                    " cloning requests")
            if len(prompt_feat) > self.prompt_frames:
                raise ValueError(
                    f"cloning prompt is {len(prompt_feat)} frames, past this lane's "
                    f"{self.prompt_frames}-frame capacity: trim the reference audio or "
                    "raise prompt_frames")
        handle = _StreamHandle()
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("streaming lane is closed")
            self._q.put((handle, dict(text=text, lang=lang, phone=phone, spk_embed=spk_embed,
                                      length_scale=length_scale, prompt_feat=prompt_feat,
                                      prompt_h=prompt_h)))
        return handle

    def close(self, timeout: float = 30.0) -> None:
        """Stop taking streams and fail the queued ones. The live streams
        belong to the worker, which fails them as it exits (touching them
        here would race a tick that outlasts the join)."""
        with self._submit_lock:
            self._stop.set()
            self._q.put(None)
        self._worker.join(timeout)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[0]._q.put(RuntimeError("streaming lane is closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker --------------------------------------------------------------

    def _admit(self, block: bool) -> None:
        """Open queued streams into free slots; a failure fails only that
        stream's handle."""
        while self._ms.active < self._ms.S:
            try:
                item = self._q.get(timeout=0.05) if block else self._q.get_nowait()
            except queue.Empty:
                return
            if item is None:
                return
            handle, req = item
            if handle.cancelled:  # the client gave up while queued
                handle._q.put(_StreamHandle._DONE)
                continue
            try:
                mu_y, c, y_len = self.synth.prepare_stream(
                    req["text"], lang=req["lang"], phone=req["phone"],
                    spk_embed=req["spk_embed"], length_scale=req["length_scale"],
                )
                sid = self._ms.open(mu_y, c, req["prompt_feat"], req["prompt_h"])
                self._handles[sid] = (handle, y_len * self._spf)
            except Exception as e:  # noqa: BLE001 — one stream's failure is its own
                handle._q.put(e)
            block = False  # block only while the lane is idle

    def _reap_cancelled(self) -> None:
        """Free the slots of cancelled streams (a client went away), so they
        admit waiting streams instead of decoding into an abandoned queue."""
        for sid, (handle, _rem) in list(self._handles.items()):
            if handle.cancelled:
                self._ms.close(sid)
                del self._handles[sid]
                handle._q.put(_StreamHandle._DONE)

    def _run(self) -> None:
        with _worker_context(self.synth.device):
            self._serve()

    def _serve(self) -> None:
        while not self._stop.is_set():
            self._reap_cancelled()
            self._admit(block=self._ms.active == 0)
            if self._ms.active == 0:
                continue
            try:
                chunks, finished = self._ms.tick()
                for sid, wav in chunks.items():
                    handle, remaining = self._handles[sid]
                    emit = wav[: max(0, min(len(wav), remaining))]
                    if len(emit):
                        handle._q.put(emit)
                    self._handles[sid] = (handle, remaining - len(emit))
                for sid in finished:
                    handle, _rem = self._handles.pop(sid)
                    handle._q.put(_StreamHandle._DONE)
            except Exception as e:  # noqa: BLE001 — a failed tick fails its streams
                # but keeps the lane alive for new streams
                for handle, _rem in self._handles.values():
                    handle._q.put(e)
                self._handles.clear()
                self._ms.reset()
        # the worker owns the live streams: fail the ones still open
        for handle, _rem in self._handles.values():
            handle._q.put(RuntimeError("streaming lane is closed"))
        self._handles.clear()
