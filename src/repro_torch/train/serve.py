"""LM serving (prefill, decode, a sampler) and the batched FiGaRo
factorization server.

The port of the JAX package's ``train/serve.py``. ``make_prefill`` and
``make_decode_step`` close over a configuration as JAX's do, taking the
`Transformer` where JAX takes its parameters; the decode step writes the
cache in place (`Transformer.decode_step`). ``sample_loop`` prefills, then
samples greedily or at a temperature: on the card it runs the first decode
step eagerly and replays the rest from one CUDA graph (`DecodeGraph`), the
counterpart of the ``jax.jit`` JAX's loop applies; on the CPU it runs
eagerly. ``cache_specs`` needs the port's sharding rules (ROADMAP A14.6).

``make_figaro_server`` serves one join structure (a `FigaroPlan`) to many
concurrent users' feature-sets — each dispatch runs Algorithm 2 and the
post-processing over a leading batch axis through a `FigaroEngine` with
donated request tensors, so serving cost per request is one replay of the
bucket's captured graph on the card. The server is async-first
(`repro_torch.train.async_serve`): ``submit(request)`` returns a
`FigaroFuture`, pending requests coalesce into bucketed micro-batches, and
queue depth >= 2 overlaps the next batch's host-to-device copy with the
in-flight dispatch; the synchronous `FigaroServer` call is a
``submit(...).result()`` wrapper.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import FigaroEngine, _plan_arg_error
from repro_torch.core.join_tree import FigaroPlan
from repro_torch.core.plan_cache import PlanHolder, plan_signature
from repro_torch.kernels import _platform
from repro_torch.kernels._platform import resolve_device
from repro_torch.launch.mesh import resolve_shard
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer
from repro_torch.train.async_serve import (AsyncFigaroServer, FigaroFuture,
                                           SERVE_KINDS, validate_serve_kind)

__all__ = ["make_prefill", "make_decode_step", "cache_specs", "sample_loop",
           "DecodeGraph", "make_figaro_server", "FigaroServer",
           "AsyncFigaroServer", "FigaroFuture", "SERVE_KINDS",
           "validate_serve_kind"]


class FigaroServer(AsyncFigaroServer):
    """The synchronous face of `AsyncFigaroServer`.

    ``server(data_batch)`` is exactly ``server.submit(data_batch).result()``:
    the request rides the same micro-batching queue and pipelined dispatch,
    the call just blocks for its own answer. ``server.append(node, rows)``
    (``rows = (key_columns, data_rows)`` as in `plan_cache.refresh_plan`)
    drains in-flight work and refreshes the shared plan holder: as long as
    the new live sizes fit the plan's bucketed capacities, the next dispatch
    replays the captured graph — no signature miss under streaming appends.

    Capacity contract for requests: batch leaves are [B, rows_i, n_i] in the
    plan's (sorted) row order with ``rows_i`` either the node's live size or
    its full capacity; live-sized leaves are zero-padded up to capacity
    (the dead rows are masked out inside the pipeline regardless).
    """


def make_figaro_server(plan: FigaroPlan | PlanHolder, *, kind: str = "qr",
                       label_col: int | None = None, k: int | None = None,
                       ridge: float = 0.0, dtype=torch.float32,
                       method: str = "tsqr", leaf_rows: int = 256,
                       use_kernel: bool = False, assembly: str = "padded",
                       engine: FigaroEngine | None = None, mesh=None,
                       shard_axis: str = "data", max_batch: int = 32,
                       queue_depth: int = 2, device=None) -> FigaroServer:
    """Batched FiGaRo serving endpoint for one join structure.

    Returns a `FigaroServer` (an `AsyncFigaroServer` whose ``__call__``
    blocks) — ``server.submit(request)`` enqueues per-node [m_i, n_i]
    request leaves (or a [B, m_i, n_i] sub-batch) and returns a
    `FigaroFuture`; ``server(data_batch)`` answers synchronously:

      kind="qr"   -> R      [B, N, N]
      kind="svd"  -> (s [B, N], Vt [B, N, N])
      kind="pca"  -> PCAResult with a leading batch axis (top-``k``)
      kind="lsq"  -> (betas [B, N-1], residuals [B]) against ``label_col``

    Pending requests are coalesced up to ``max_batch`` rows and the batch is
    padded to its bucketed capacity (powers of two), so every kind answers
    the whole coalesced batch with one dispatch, and the engine's cache and
    captured graphs track batch *buckets*, not every live batch size.
    ``queue_depth`` coalesced batches may be in flight at once: at depth
    >= 2 the next batch's staging overlaps the in-flight dispatch.

    The server runs on ``device`` (default: the card; ``"cpu"`` runs the
    kernels' plain versions). With a capacity plan
    (`plan_cache.build_capacity_plan`) the server also exposes
    ``server.append(node, rows)`` for online data refreshes. Pass a
    `plan_cache.PlanHolder` to share plan state with other surfaces (this is
    what ``JoinDataset.serve`` does — dataset and server then see one plan,
    never a fork).

    Without ``engine=``, the server builds a donating engine (request
    tensors are consumed by the dispatch that answers them). With a
    ``mesh`` (`launch.mesh.DataMesh`) the batch capacities are aligned to
    ``mesh[shard_axis]`` and every batch dispatches through
    ``shard=(mesh, shard_axis)``, as in the JAX package. Over P > 1 ranks
    (one process each) construction is collective: every rank calls this
    with a plan built from the same tables and the same options (checked
    on every rank; a mismatch raises `ValueError` on all of them). Rank 0's
    server decides each batch and takes requests, appends and ``close``;
    every other rank's server follows rank 0's stream (its ``close``
    returns when rank 0 closes) — see `repro_torch.train.async_serve`. On
    one rank nothing is exchanged. `repro_torch.figaro` (`Session.serve` /
    `JoinDataset.serve`) is the façade over this constructor — it fills
    engine, device, mesh and dtype from the session and resolves
    ``label_col`` by column name.
    """
    validate_serve_kind(kind, label_col=label_col, check_label=True)
    device = resolve_device(device)
    shard = None
    if mesh is not None:
        shard = resolve_shard(mesh, shard_axis)
        mesh.check_device(device)
        mesh.local_rank()
        mesh.check_control()
    if isinstance(plan, PlanHolder):
        holder = plan
    else:
        if not isinstance(plan, FigaroPlan):
            raise TypeError(_plan_arg_error("plan", plan))
        holder = PlanHolder(plan)
    engine = engine if engine is not None else FigaroEngine(donate_data=True)

    # use_kernel / assembly are part of every dispatch's signature, so the
    # serving graphs are the fused-kernel / band-assembly programs when the
    # session (or caller) asked for them.
    common = dict(batched=True, shard=shard, dtype=dtype, method=method,
                  leaf_rows=leaf_rows, use_kernel=use_kernel,
                  assembly=assembly, device=device)
    dispatch = {
        "qr": lambda plan, batch, cap: engine.qr(
            plan, batch, batch_capacity=cap, **common),
        "svd": lambda plan, batch, cap: engine.svd(
            plan, batch, batch_capacity=cap, **common),
        "pca": lambda plan, batch, cap: engine.pca(
            plan, batch, batch_capacity=cap, k=k, **common),
        "lsq": lambda plan, batch, cap: engine.least_squares(
            plan, label_col, batch, batch_capacity=cap, ridge=ridge,
            **common),
    }[kind]
    config = None
    if mesh is not None and mesh.size > 1 and holder.plan is not None:
        # What every rank must share with rank 0 (its dispatch thread
        # checks it on every rank before the first request).
        config = {"plan": plan_signature(holder.plan), "kind": kind,
                  "label_col": label_col, "k": k, "ridge": ridge,
                  "dtype": str(dtype), "method": method,
                  "leaf_rows": leaf_rows, "use_kernel": use_kernel,
                  "assembly": assembly, "axis": shard_axis}
    server = FigaroServer(holder, dispatch, engine=engine, device=device,
                          max_batch=max_batch, queue_depth=queue_depth,
                          mesh=shard, config=config)
    holder.attach(server)
    return server


# -- the LM: prefill, decode, sampling -----------------------------------------


def make_prefill(cfg: ModelConfig, max_len: int, device=None):
    """``prefill_fn(model, batch) -> (logits [B, padded_vocab], cache)`` for
    a `repro_torch.models.transformer.Transformer` on ``device`` (the card
    unless ``device="cpu"``): ``batch["tokens"]`` [B, T], with the
    ``"frames"`` of an encoder-decoder or the ``"patches"`` of a patch
    config (arrays or tensors, moved to the device), into a new cache of
    ``max_len`` positions, in inference mode."""
    dev = resolve_device(device)

    def prefill_fn(model, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        with torch.inference_mode():
            return model.prefill(batch, max_len, cfg)

    return prefill_fn


def make_decode_step(cfg: ModelConfig, device=None):
    """``decode_fn(model, cache, tokens) -> (logits [B, padded_vocab],
    cache)`` on ``device`` (the card unless ``device="cpu"``): one eager
    step of tokens [B, 1]. The cache is consumed: it is written in place
    and comes back (`Transformer.decode_step`)."""
    dev = resolve_device(device)

    def decode_fn(model, cache, tokens):
        tokens = torch.as_tensor(tokens).to(dev)
        with torch.inference_mode():
            return model.decode_step(cache, tokens, cfg)

    return decode_fn


def cache_specs(cfg: ModelConfig, mesh, *, shard_seq: bool = False,
                kv_seq_over_model: bool = True):
    """The decode cache's partition specs over a mesh: not ported yet."""
    raise NotImplementedError(
        "cache_specs needs the port's sharding rules (ROADMAP A14.6, "
        "sharding/rules.py)")


class DecodeGraph:
    """One decode step of ``model`` under ``cfg`` over ``cache``, captured
    as a CUDA graph (the card only).

    The graph's inputs are a static token buffer [B, 1] and the cache's own
    tensors, which every replay advances in place as an eager
    `Transformer.decode_step` would. ``graph(tokens)`` copies ``tokens``
    into the buffer, replays on the current stream and returns the logits
    buffer [B, padded_vocab], which the next replay overwrites. A replay
    equals the eager step (`make_decode_step`) from the same cache and
    tokens bit for bit. Capturing records the kernels and runs none, so
    the cache is left as it was; run one eager step on the cache first, as
    `sample_loop` does. ``launches`` are the kernel launches the capture
    recorded (`_platform.recording_launches`), added to the counts on
    every replay. `close` frees the graph and its memory pool.
    """

    def __init__(self, model, cfg: ModelConfig, cache: dict, tokens):
        device = cache["pos"].device
        stream = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        self.graph = torch.cuda.CUDAGraph()
        with torch.inference_mode():
            self.tokens = tokens.clone()
            with torch.cuda.stream(stream), \
                    _platform.recording_launches() as launches:
                with torch.cuda.graph(self.graph, stream=stream,
                                      capture_error_mode="thread_local"):
                    # Named through the class so that the port's lint
                    # resolves the capture root (FGT009, FGT010).
                    self.logits, _ = Transformer.decode_step(
                        model, cache, self.tokens, cfg)
        current.wait_stream(stream)
        self.launches = dict(launches)

    def __call__(self, tokens) -> torch.Tensor:
        with torch.inference_mode():
            self.tokens.copy_(tokens)
        self.graph.replay()
        _platform.add_launches(self.launches)
        return self.logits

    def close(self) -> None:
        self.graph.reset()
        self.tokens = self.logits = None


def _next_token(logits, temperature: float, generator):
    """Greedy (``temperature`` 0) or a sample of softmax(logits /
    temperature) by the Gumbel-max rule, as ``jax.random.categorical``
    draws it: [B, 1] int32."""
    if temperature > 0:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
        logits = logits / temperature - torch.log(-torch.log(u))
    return logits.argmax(-1)[:, None].to(torch.int32)


def sample_loop(model, cfg: ModelConfig, batch, *, steps: int, max_len: int,
                temperature: float = 0.0, generator=None, device=None):
    """Greedy / temperature sampling: prefill ``batch``, then ``steps``
    decode steps. Returns the tokens [B, steps] (int32): the prompt's
    greedy next token, then one token a step.

    ``generator`` (a `torch.Generator` on the device; default: the
    device's) draws the temperature samples where JAX folds a key, so
    sampled tokens differ from JAX's; greedy ones agree. On the card the
    first decode step runs eagerly and one `DecodeGraph` replays the rest;
    it is freed before the tokens are returned. On the CPU every step runs
    eagerly."""
    dev = resolve_device(device)
    prefill = make_prefill(cfg, max_len, dev)
    decode = make_decode_step(cfg, dev)
    graph = None
    with torch.inference_mode():
        logits, cache = prefill(model, batch)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        toks = []
        try:
            for i in range(steps):
                toks.append(tok)
                if i == 1 and dev.type == "cuda":
                    graph = DecodeGraph(model, cfg, cache, tok)
                if graph is None:
                    logits, cache = decode(model, cache, tok)
                else:
                    logits = graph(tok)
                tok = _next_token(logits, temperature, generator)
        finally:
            if graph is not None:
                graph.close()
        return torch.cat(toks, dim=1)
