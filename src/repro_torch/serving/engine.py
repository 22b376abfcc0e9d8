"""Multi-tenant coded serving engine: continuous batching over one JobMux.

Every token step, each in-flight request's routed expert-FFN product is
submitted as one coded matmul job -- many concurrent jobs, one per
request, against ONE shared worker pool (``runtime.executor.JobMux``).
The model on the device stays authoritative for the logits (its MoE runs
the same coded encode/decode when ``opt_coded_moe`` is on, with the decode
matrix ``D`` held as a device tensor that a survivor set re-binds without
re-planning); the JobMux job is the distributed execution of one expert
product, which (a) is checked exact against the host's uncoded float64
product every token and (b) supplies the latency and fault model: a
token's latency is the model's step plus the job's completion time.

Coded and uncoded arms differ ONLY in the code on the wire: the same pool
size, the same block split of the expert weight, the same model.  The
uncoded code places one block per worker, so a dead worker fails the
request; the coded scheme decodes from any sufficient prefix and records a
straggler recovery instead.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.coded.registry import get_scheme
from repro_torch.core import schemes as schemes_lib
from repro_torch.core.blocks import resolve_device
from repro_torch.models import moe as moe_lib
from repro_torch.models.registry import build
from repro_torch.runtime.executor import JobMux, MuxJob
from repro_torch.serving.scheduler import ContinuousBatcher, Request, ServingMetrics
from repro_torch.serving.serve_step import make_decode_step


@dataclasses.dataclass
class _Live:
    """Per-request decode state while the request holds a batch slot."""

    cache: dict
    tok: int
    rng: torch.Generator
    pending_tok: int = -1


class ServingEngine:
    """Continuous-batching generation with coded expert-FFN offload.

    ``coded=True`` turns on ``opt_coded_moe`` in the model config AND uses
    the config's coded scheme for the per-token jobs; ``coded=False`` keeps
    the plain model and submits uncoded jobs.  ``source``,
    ``straggler_sleep``, ``dead_workers`` and ``straggler`` configure the
    shared pool as ``JobMux`` does; a started source object (a
    ``MuxProcPool`` on this engine's device) may be passed instead.

    ``device`` (None = the CUDA card, raising where there is none; or
    ``"cpu"``) holds the model, its caches and the pool's blocks.
    ``params`` (the model's parameter tree on that device, e.g. from
    ``models.convert``) replaces the seeded init.
    """

    def __init__(self, cfg, *, coded: bool = True, num_workers: int = 6,
                 source="sim", n_blocks: int = 4, num_chunks: int = 2,
                 straggler=None, straggler_sleep=None, dead_workers=(),
                 timeout: float = 60.0, max_batch: int = 4, seed: int = 0,
                 max_seq: int = 64, moe_survivors=None,
                 unit_block_time: float = 1.0, device=None, params=None):
        if cfg.moe is None:
            raise ValueError(f"{cfg.name}: ServingEngine needs a MoE config "
                             "(the coded jobs are expert-FFN products)")
        self.device = resolve_device(device)
        self.coded = bool(coded)
        if self.coded and not getattr(cfg, "opt_coded_moe", False):
            cfg = cfg.with_opts(["coded_moe"])
        self.cfg = cfg
        self.n_blocks = int(n_blocks)
        self.num_chunks = int(num_chunks)
        self.max_batch = int(max_batch)
        self.max_seq = int(max_seq)

        self.model = build(cfg, self.device)
        self.params = self.model.init(seed) if params is None else params
        if self.params["embed"].device != self.device:
            raise ValueError(f"params on {self.params['embed'].device}, "
                             f"engine on {self.device}")

        # host mirrors (float64) for routing and the exactness checks: group
        # 0 of the first MoE slot (slot params are stacked over groups).  The
        # reference takes the first slot whose FFN has a ``w_gate``, which in
        # a hybrid (jamba: a dense SwiGLU slot first) is no MoE, and fails
        ffn = next(p["ffn"] for p in self.params["groups"].values()
                   if "router" in p["ffn"])
        self._router = _host_f64(ffn["router"][0])               # (d, E)
        self._w_gate = _host_f64(ffn["w_gate"][0])               # (E, d, ff)
        self._embed = _host_f64(self.params["embed"])            # (V, d)

        # the code on the wire: the same (m=1, n=n_blocks) block grid both arms
        if self.coded:
            self._code = get_scheme(cfg.coded.scheme).instance(
                1, self.n_blocks, num_workers, seed=seed)
        else:
            self._code = schemes_lib.uncoded(1, self.n_blocks)
        if self._code.num_workers > num_workers:
            raise ValueError(f"code wants {self._code.num_workers} workers, "
                             f"pool has {num_workers}")

        if isinstance(source, str):
            self.mux = JobMux(num_workers, source=source, straggler=straggler,
                              straggler_sleep=straggler_sleep,
                              dead_workers=dead_workers, timeout=timeout,
                              unit_block_time=unit_block_time, device=self.device)
        else:
            self.mux = JobMux(num_workers, source=source, device=self.device)

        # the model's decode matrix, a device tensor re-bound for the
        # survivors (raising DecodingError here on a rank loss); a dummy
        # when the model path is uncoded
        if self.coded:
            D = moe_lib.coded_moe_decode_matrix(cfg, survivors=moe_survivors)
        else:
            D = np.zeros((1, 1), dtype=np.float32)
        self._D = torch.as_tensor(D, device=self.device)
        self._step = make_decode_step(self.model, 0.0)

    # ------------------------------ pieces -----------------------------------

    def _prefill(self, tokens: torch.Tensor):
        with moe_lib.coded_moe_decode(self._D):
            return self.model.prefill(self.params, tokens, max_seq=self.max_seq,
                                      cache_dtype=torch.float32)

    def _decode(self, cache: dict, tok: int, rng: torch.Generator):
        tokens = torch.tensor([[tok]], dtype=torch.int32, device=self.device)
        with moe_lib.coded_moe_decode(self._D):
            return self._step(self.params, cache, tokens, rng)

    def _prompt(self, req: Request) -> torch.Tensor:
        rng = np.random.default_rng(req.prompt_seed)
        toks = rng.integers(0, self.cfg.vocab_size, size=(1, req.prompt_len))
        return torch.as_tensor(toks, dtype=torch.int32, device=self.device)

    def _expert_job(self, req: Request, token: int):
        """The distributed job for ``token``'s expert product, plus the host
        operands for the exactness check."""
        x = self._embed[token]                       # (d,)
        e = int(np.argmax(x @ self._router))         # layer-0 routed expert
        W = self._w_gate[e]                          # (d, ff)
        job = MuxJob(code=self._code, A_blocks=[x[:, None]],
                     B_blocks=np.array_split(W, self.n_blocks, axis=1),
                     n=self.n_blocks, num_chunks=self.num_chunks, tag=req.rid)
        return job, x, W

    @staticmethod
    def _exact(blocks, x, W) -> bool:
        got = torch.hstack([b.reshape(1, -1) for b in blocks]).cpu().numpy()
        return bool(np.allclose(got, x[None, :] @ W, rtol=1e-6, atol=1e-8))

    def warmup(self, prompt_lens=(8,)) -> None:
        """Pay the cold paths outside the measured serving loop: one
        throwaway prefill per prompt length plus one decode micro-step, and
        one throwaway expert job through the shared mux (chunk expansion,
        decode planning)."""
        for plen in sorted(set(int(p) for p in prompt_lens)):
            toks = torch.zeros((1, plen), dtype=torch.int32, device=self.device)
            logits, cache = self._prefill(toks)
            int(torch.argmax(logits[:, -1], dim=-1)[0])
            self._decode(cache, 0, torch.Generator(device=self.device))
        self.mux.start()
        warm = Request(rid="__warmup__", tenant="__warmup__",
                       arrival_time=0.0, prompt_len=1, max_new_tokens=1)
        job, _, _ = self._expert_job(warm, 0)
        self.mux.run([job])

    # ------------------------------ the loop ---------------------------------

    def run(self, requests: list[Request], *,
            metrics: ServingMetrics | None = None) -> ServingMetrics:
        """Serve an (open-loop) trace of requests to completion.

        Wall clock replays ``arrival_time``s; every iteration admits into
        free slots, prefills newcomers, runs ONE decode micro-step per
        running request, and dispatches the whole step's expert jobs as one
        concurrent JobMux batch.
        """
        self.mux.start()
        metrics = metrics if metrics is not None else ServingMetrics()
        pending = sorted(requests, key=lambda r: (r.arrival_time, r.rid))
        batcher = ContinuousBatcher(self.max_batch)
        live: dict[str, _Live] = {}
        t_base = time.perf_counter()

        def now() -> float:
            return time.perf_counter() - t_base

        def finish(req: Request, error: str | None = None) -> None:
            req.error = error
            batcher.retire(req, now())
            metrics.record(req)
            live.pop(req.rid, None)

        while pending or batcher.waiting or batcher.running:
            t = now()
            while pending and pending[0].arrival_time <= t:
                batcher.submit(pending.pop(0))
            if not batcher.running and not batcher.waiting:
                # idle: sleep toward the next arrival, then re-check
                time.sleep(min(max(pending[0].arrival_time - t, 0.0), 0.02))
                continue

            for req in batcher.admit(now()):
                logits, cache = self._prefill(self._prompt(req))
                tok = int(torch.argmax(logits[:, -1], dim=-1)[0])
                req.first_token_time = now()
                req.tokens.append(tok)
                if len(req.tokens) >= req.max_new_tokens:
                    finish(req)
                    continue
                live[req.rid] = _Live(
                    cache=cache, tok=tok,
                    rng=torch.Generator(device=self.device).manual_seed(req.prompt_seed))

            # one decode micro-step for every running request; the step's
            # expert jobs go to the pool as ONE concurrent batch
            batch = list(batcher.running)
            if not batch:
                continue
            jobs, operands, step_wall = [], {}, {}
            for req in batch:
                st = live[req.rid]
                ts = time.perf_counter()
                tok_arr, st.cache = self._decode(st.cache, st.tok, st.rng)
                st.pending_tok = int(tok_arr[0, 0])
                step_wall[req.rid] = time.perf_counter() - ts
                job, x, W = self._expert_job(req, st.tok)
                jobs.append(job)
                operands[req.rid] = (x, W)

            for req, res in zip(batch, self.mux.run(jobs)):
                st = live[req.rid]
                if not res.ok:
                    finish(req, error=res.error)
                    continue
                x, W = operands[req.rid]
                if not self._exact(res.report.blocks, x, W):
                    finish(req, error="decoded expert product mismatch")
                    continue
                if res.report.workers_used < res.report.num_workers:
                    req.straggler_recoveries += 1
                req.token_latencies.append(step_wall[req.rid]
                                           + res.report.total_time)
                req.tokens.append(st.pending_tok)
                st.tok = st.pending_tok
                if len(req.tokens) >= req.max_new_tokens:
                    finish(req)
        return metrics

    # -------------------------------------------------------------------------

    def close(self) -> None:
        self.mux.close()

    def __enter__(self) -> "ServingEngine":
        self.mux.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _host_f64(t: torch.Tensor) -> np.ndarray:
    """A host float64 copy of a device tensor (cast on the host, so the
    card never holds a float64 copy)."""
    return t.to("cpu", torch.float32).numpy().astype(np.float64)
