"""T5 encoder-decoder and its generation, the port of
``tpu_pipelines/models/t5.py``.

T5's particulars over the transformer blocks: RMSNorm pre-normalization,
log-bucketed relative-position bias shared across each stack's
self-attention layers, T5's hidden-site MLP dropout, and the input
embedding tied to the output projection, scaled by ``d_model ** -0.5`` with
the logits in f32.  Weights come from a flax tree through
``models/convert.py`` or from :func:`init_t5_weights`.

Generation runs eagerly: the encoder once per row, then one single-token
decoder pass per step against the decode cache (a dict of tensors written
in place, see ``models/transformer.py``).  Every entry point takes
``params`` (a state dict) as the reference's jitted functions do: the
module's own tensors run the module as it is, any other dict runs it
through ``torch.func.functional_call``.  The decode contract's ``verify``
scores a ``[b, q]`` window of fed tokens in one decoder pass (the
speculative-decoding verify); ``t5_partition_rules`` is in
``parallel/partition.py``.

A ``mesh`` goes to every block, as the reference's.  On a ``model`` axis
n > 1 the blocks hold their rank's heads and MLP columns, each stack's
relative-position table its rank's H/n heads (so the bias lines up with
the heads in every branch: full, decode row, per-row vector, verify
window), and ``shared`` its V/n vocabulary rows: the lookup is BERT's
(``vocab_parallel_lookup``) and the tied logits are the rank's V/n
columns, gathered by ``leave_split``, so every rank holds the full
logits and makes the same greedy and beam choices.  The decode caches
hold the rank's heads.  On a ``seq`` axis whose ``seq_split`` is set (a
``batch_partition`` over ``seq``) a rank holds its block of ``inputs``
and ``targets``: the bias is built for the whole length, self-attention
gathers its keys and attends globally (biased attention is dense, as the
reference's), cross-attention gathers the encoder's output, and the
right shift of the decoder's inputs takes the previous rank's last
target.  Unsplit (``seq``, ``expert`` or ``pipe`` without a
``batch_partition``) T5 is replicated, as the reference replicates it.
"""

from __future__ import annotations

import math
import threading
from types import SimpleNamespace
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_pipelines_torch.models.transformer import (
    RMSNorm,
    TransformerBlock,
    _model_split,
    _seq_split,
    vocab_parallel_lookup,
)
from tpu_pipelines_torch.parallel import collectives
from tpu_pipelines_torch.parallel.partition import (
    draw_whole,
    hold_slices,
    slice_group,
)

Cache = Dict[str, torch.Tensor]


def relative_position_buckets(
    qlen: int, klen: int, *, bidirectional: bool, num_buckets: int = 32,
    max_distance: int = 128,
) -> torch.Tensor:
    """T5's log-bucketed relative positions; returns int32 [qlen, klen]."""
    ctx = np.arange(qlen)[:, None]
    mem = np.arange(klen)[None, :]
    rel = mem - ctx
    buckets = np.zeros_like(rel)
    n = num_buckets
    if bidirectional:
        n //= 2
        buckets += (rel > 0).astype(np.int64) * n
        rel = np.abs(rel)
    else:
        rel = -np.minimum(rel, 0)
    max_exact = n // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (n - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, n - 1)
    buckets += np.where(is_small, rel, large)
    return torch.from_numpy(buckets.astype(np.int32))


class RelativePositionBias(nn.Module):
    """The additive f32 score bias from a [num_buckets, heads] table.

    ``row`` None gives the full [1, h, q, k] bias; a scalar (incremental
    decode: every row at one position) the one bucket row [1, h, 1, k]; a
    [b] vector (continuous batching: each row at its own position) one
    bucket row per sequence, [b, h, 1, k]; a [b, q] matrix (the speculative
    verify window: query j of row i at ``row[i, j]``) one bucket row per
    query, [b, h, q, k].  On a ``mesh`` whose ``model`` axis is n > 1 the
    table holds the rank's H/n heads and ``h`` is theirs."""

    def __init__(self, n_heads: int, bidirectional: bool, num_buckets: int = 32,
                 max_distance: int = 128, mesh: Any = None):
        super().__init__()
        self.bidirectional = bidirectional
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        n, group = _model_split(mesh, n_heads, "heads")
        self.rel_embedding = nn.Parameter(torch.zeros(num_buckets, n_heads // n))
        hold_slices(self, {"rel_embedding": (1, group)})
        self._tables: Dict[Any, torch.Tensor] = {}

    def _buckets(self, qlen: int, klen: int, device) -> torch.Tensor:
        key = (qlen, klen, str(device))
        table = self._tables.get(key)
        if table is None:
            table = relative_position_buckets(
                qlen, klen, bidirectional=self.bidirectional,
                num_buckets=self.num_buckets, max_distance=self.max_distance,
            ).long().to(device)
            self._tables[key] = table
        return table

    def forward(self, qlen: int, klen: int, row=None) -> torch.Tensor:
        table = self.rel_embedding.float()
        buckets = self._buckets(qlen, klen, table.device)
        if row is None:
            return table[buckets].permute(2, 0, 1)[None]
        if isinstance(row, torch.Tensor) and row.dim() == 2:
            return table[buckets[row]].permute(0, 3, 1, 2)
        if isinstance(row, torch.Tensor) and row.dim() == 1:
            return table[buckets[row]].permute(0, 2, 1)[:, :, None, :]
        r = int(row)
        return table[buckets[r:r + 1]].permute(2, 0, 1)[None]


class T5Stack(nn.Module):
    """The encoder (``causal=False``) or the decoder (``causal=True``, with
    cross-attention); ``name`` prefixes the stack's decode-cache keys."""

    def __init__(self, name: str, *, d_model: int, n_layers: int, n_heads: int,
                 head_dim: int, d_ff: int, dropout_rate: float,
                 dtype: torch.dtype, causal: bool, attn_impl: str = "dense",
                 mesh: Any = None):
        super().__init__()
        self.cache_name = name
        self.mesh = mesh
        self.rel_pos = RelativePositionBias(n_heads, bidirectional=not causal,
                                            mesh=mesh)
        self.layers = nn.ModuleList(
            TransformerBlock(
                d_model, n_heads, head_dim, d_ff, dropout_rate=dropout_rate,
                dtype=dtype, attn_impl=attn_impl, causal=causal, prenorm=True,
                use_cross=causal, norm="rmsnorm", mlp_dropout_site="hidden",
                mesh=mesh,
            )
            for _ in range(n_layers)
        )
        self.final_norm = RMSNorm(d_model, dtype)

    def forward(
        self,
        x: torch.Tensor,
        *,
        encoded: Optional[torch.Tensor] = None,
        kv_mask: Optional[torch.Tensor] = None,
        enc_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        decode_pos=None,
        max_decode_len: Optional[int] = None,
        cache: Optional[Cache] = None,
    ) -> torch.Tensor:
        if decode_pos is not None:
            # One-token decode step: the bias is the row of the full
            # [max_decode_len, max_decode_len] matrix at this step's
            # position; the cache's <= pos validity gives the causality.
            # A multi-token input with per-row positions is the verify
            # window: query j of row i sits at decode_pos[i] + j.
            row = decode_pos
            if (isinstance(row, torch.Tensor) and row.dim() == 1
                    and x.shape[1] > 1):
                row = row[:, None] + torch.arange(
                    x.shape[1], device=row.device)[None, :]
            bias = self.rel_pos(max_decode_len, max_decode_len, row=row)
            kv_mask = None
        else:
            # On a split sequence x is this rank's block: the bias spans
            # the whole sequence, which self-attention gathers.
            length = x.shape[1] * (self.mesh.axis_size("seq")
                                   if _seq_split(self.mesh) else 1)
            bias = self.rel_pos(length, length)
        for i, layer in enumerate(self.layers):
            x = layer(
                x, kv_mask, generator, encoded=encoded, enc_mask=enc_mask,
                self_bias=bias, decode_pos=decode_pos,
                max_decode_len=max_decode_len, cache=cache,
                cache_prefix=f"{self.cache_name}.layer_{i}",
            )
        return self.final_norm(x)


class T5(nn.Module):
    """batch {inputs, targets [, input_mask, target_mask]} -> vocab logits.

    ``targets`` are teacher-forcing decoder inputs shifted right inside
    (BOS = 0, the T5 convention).  ``mesh``: see the module docstring."""

    def __init__(
        self,
        vocab_size: int = 32128,
        d_model: int = 512,
        n_layers: int = 6,
        n_heads: int = 8,
        head_dim: int = 64,
        d_ff: int = 2048,
        dropout_rate: float = 0.1,
        dtype: torch.dtype = torch.bfloat16,
        attn_impl: str = "dense",
        mesh: Any = None,
    ):
        super().__init__()
        self.d_model = d_model
        self.dtype = dtype
        self.mesh = mesh
        n, group = _model_split(mesh, vocab_size, "vocabulary rows")
        self.shared = nn.Embedding(vocab_size // n, d_model)
        hold_slices(self.shared, {"weight": (0, group)})
        common = dict(d_model=d_model, n_layers=n_layers, n_heads=n_heads,
                      head_dim=head_dim, d_ff=d_ff, dropout_rate=dropout_rate,
                      dtype=dtype, attn_impl=attn_impl, mesh=mesh)
        self.encoder = T5Stack("encoder", causal=False, **common)
        self.decoder = T5Stack("decoder", causal=True, **common)

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        # flax Embed(dtype=...): the gathered rows in the compute dtype.
        return vocab_parallel_lookup(ids.long(), self.shared.weight,
                                     slice_group(self.shared, "weight")
                                     ).to(self.dtype)

    def encode(self, inputs, input_mask=None, generator=None) -> torch.Tensor:
        return self.encoder(self._embed(inputs), kv_mask=input_mask,
                            generator=generator)

    def decode(
        self,
        decoder_input_ids,
        encoded,
        *,
        target_mask=None,
        enc_mask=None,
        generator=None,
        decode_pos=None,
        max_decode_len=None,
        cache: Optional[Cache] = None,
    ) -> torch.Tensor:
        """f32 logits [b, l, vocab]; with ``decode_pos`` one step against
        ``cache`` (filled or written in place)."""
        y = self.decoder(
            self._embed(decoder_input_ids), encoded=encoded,
            kv_mask=target_mask, enc_mask=enc_mask, generator=generator,
            decode_pos=decode_pos, max_decode_len=max_decode_len, cache=cache,
        )
        # The tied embedding as the output projection, T5's 1/sqrt(d)
        # scaling; logits in f32 (vocabulary-parallel on a model axis: the
        # rank's columns, gathered).
        group = slice_group(self.shared, "weight")
        y = collectives.enter_partial(y * (self.d_model ** -0.5), group)
        logits = torch.einsum("bld,vd->blv", y.float(), self.shared.weight.float())
        return collectives.leave_split(logits, -1, group)

    def forward(self, *args, method: Optional[str] = None, **kwargs):
        """Teacher-forced logits: ``model(batch, generator=None)``.
        ``method="encode"`` or ``"decode"`` runs that entry with the same
        arguments instead, as flax ``apply(method=...)`` does, so that
        ``torch.func.functional_call`` reaches every entry."""
        if method is not None:
            return getattr(self, method)(*args, **kwargs)
        return self._teacher_forced(*args, **kwargs)

    def _teacher_forced(self, batch: Dict[str, Any],
                        generator: Optional[torch.Generator] = None):
        inputs = torch.as_tensor(batch["inputs"])
        targets = torch.as_tensor(batch["targets"])
        input_mask = batch.get("input_mask")
        decoder_inputs = F.pad(targets, (1, 0))[:, :-1]
        if _seq_split(self.mesh):
            # The shift crosses blocks: a rank's first decoder input is
            # the previous rank's last target (the first rank's is BOS).
            n = self.mesh.axis_size("seq")
            prev = collectives.ppermute(
                targets[:, -1:], [(i, i + 1) for i in range(n - 1)],
                self.mesh.axis_group("seq"))
            decoder_inputs = torch.cat([prev, targets[:, :-1]], dim=1)
        encoded = self.encode(inputs, input_mask, generator)
        return self.decode(
            decoder_inputs, encoded, target_mask=batch.get("target_mask"),
            enc_mask=input_mask, generator=generator,
        )


DEFAULT_HPARAMS = {
    # t5-small geometry
    "vocab_size": 32128,
    "d_model": 512,
    "n_layers": 6,
    "n_heads": 8,
    "head_dim": 64,
    "d_ff": 2048,
    "dropout_rate": 0.1,
    "learning_rate": 1e-3,
    "batch_size": 64,
}


def build_t5_model(hparams: Optional[Dict] = None, mesh: Any = None) -> T5:
    """The reference's ``build_t5_model``; ``mesh`` (a ``DeviceMesh``)
    goes to every block (see the module docstring).  A vocabulary or a
    head count that a ``model`` axis does not divide raises the
    reference's ``ValueError``."""
    hp = {**DEFAULT_HPARAMS, **(hparams or {})}
    return T5(
        vocab_size=int(hp["vocab_size"]),
        d_model=int(hp["d_model"]),
        n_layers=int(hp["n_layers"]),
        n_heads=int(hp["n_heads"]),
        head_dim=int(hp["head_dim"]),
        d_ff=int(hp["d_ff"]),
        dropout_rate=float(hp["dropout_rate"]),
        attn_impl=str(hp.get("attn_impl", "dense")),
        mesh=mesh,
    )


@torch.no_grad()
def init_t5_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The flax initialisers' scales, drawn from ``generator``: Dense and
    DenseGeneral kernels lecun-normal (truncated at 2 sigma, std
    sqrt(1 / fan_in) / 0.8796), zero biases, the embedding normal with std
    sqrt(1 / d_model), the relative-position tables normal(0, 1), unit
    norm scales.  A weight a rank holds a slice of is drawn whole and
    sliced (``draw_whole``), so a model built on a mesh starts from one
    process's weights."""

    def lecun(w):
        std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)

    for name, module in model.named_modules():
        if isinstance(module, nn.Linear):
            draw_whole(module, "weight", lecun)
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            draw_whole(module, "weight", lambda w: w.normal_(
                0.0, module.embedding_dim ** -0.5, generator=generator))
        elif isinstance(module, RelativePositionBias):
            draw_whole(module, "rel_embedding",
                       lambda w: w.normal_(0.0, 1.0, generator=generator))
        elif isinstance(module, RMSNorm):
            module.weight.fill_(1.0)
    return model


# ---------------------------------------------------------------------------
# Autoregressive generation.


_FUNCTIONAL_LOCK = threading.Lock()


def _holds(model: nn.Module, params: Dict[str, torch.Tensor]) -> bool:
    """True when ``params`` are the module's own tensors (the loaded
    payload's case).  The verdict is kept for the last dict asked about,
    which the cache holds a reference to, so its id cannot be reused."""
    held = model.__dict__.get("_held_params")
    if held is not None and held[0] is params:
        return held[1]
    own = model.state_dict()
    verdict = own.keys() == params.keys() and all(
        own[n].data_ptr() == t.data_ptr() and own[n].dtype == t.dtype
        and own[n].shape == t.shape
        for n, t in params.items()
    )
    model.__dict__["_held_params"] = (params, verdict)
    return verdict


def _apply(model: T5, params, method: str, *args, **kwargs):
    """flax ``model.apply({"params": params}, ..., method=...)``."""
    if _holds(model, params):
        return getattr(model, method)(*args, **kwargs)
    # functional_call swaps the module's tensors for the call's duration:
    # one caller at a time.
    with _FUNCTIONAL_LOCK:
        return torch.func.functional_call(
            model, params, args, {**kwargs, "method": method}
        )


def _decode_one(model, params, cache, tok, encoded, enc_mask, pos,
                max_decode_len: int):
    """One single-token decoder pass; returns (cache, logits [b, V]).  A
    None cache is created (the step-0 pass); an existing one is written in
    place."""
    cache = {} if cache is None else cache
    logits = _apply(
        model, params, "decode", tok[:, None], encoded, enc_mask=enc_mask,
        decode_pos=pos, max_decode_len=max_decode_len, cache=cache,
    )
    return cache, logits[:, 0]


def prefill_decode(model, params, inputs, input_mask, max_decode_len: int,
                   pad_id: int = 0):
    """Encoder pass + the cache-creating step-0 decoder pass, once per row:
    the shared front half of greedy, beam and the continuous-batching
    engine's prefill.  Returns ``(cache, encoded, logits0 [b, V])``; the
    cache holds the BOS K/V at position 0 and the cross-attention K/V."""
    encoded = _apply(model, params, "encode", inputs, input_mask)
    bos = torch.full((inputs.shape[0],), pad_id, dtype=torch.long,
                     device=inputs.device)
    cache, logits0 = _decode_one(
        model, params, None, bos, encoded, input_mask, 0, max_decode_len
    )
    return cache, encoded, logits0


def make_continuous_decode_fns(
    model: T5,
    *,
    max_decode_len: int = 32,
    eos_id: int = 1,
    pad_id: int = 0,
    max_input_len: int = 64,
):
    """Decode fns for the continuous-batching engine
    (``serving/generative.py``):

      - ``prefill(params, inputs [1, enc_len], input_mask)`` ->
        ``(cache, encoded, logits0)``, :func:`prefill_decode`;
      - ``step(params, cache, tok [b], pos [b], encoded, enc_mask, klen)``
        -> ``(cache, logits [b, V])``: one decode step for rows at per-row
        positions ``pos`` over a cache of ``klen`` positions (the engine's
        arena slice; K/V are written into it in place);
      - ``verify(params, cache, toks [b, q], pos [b], encoded, enc_mask,
        klen)`` -> ``(cache, logits [b, q, V])``: the speculative verify,
        the q fed tokens of each row scored in one decoder pass at
        positions ``pos .. pos + q - 1`` (their K/V written into the cache
        in place);
      - the geometry constants the engine sizes its arena from."""

    def prefill(params, inputs, input_mask=None):
        return prefill_decode(
            model, params, inputs, input_mask, max_decode_len, pad_id
        )

    def step(params, cache, tok, pos, encoded, enc_mask, klen: int):
        logits = _apply(
            model, params, "decode", tok[:, None], encoded, enc_mask=enc_mask,
            decode_pos=pos, max_decode_len=klen, cache=cache,
        )
        return cache, logits[:, 0]

    def verify(params, cache, toks, pos, encoded, enc_mask, klen: int):
        logits = _apply(
            model, params, "decode", toks, encoded, enc_mask=enc_mask,
            decode_pos=pos, max_decode_len=klen, cache=cache,
        )
        return cache, logits

    return SimpleNamespace(
        prefill=prefill,
        step=step,
        verify=verify,
        max_decode_len=int(max_decode_len),
        eos_id=int(eos_id),
        pad_id=int(pad_id),
        max_input_len=int(max_input_len),
    )


def make_greedy_generate(
    model: T5,
    *,
    max_decode_len: int = 32,
    eos_id: int = 1,
    pad_id: int = 0,
    temperature: float = 0.0,
):
    """``fn(params, inputs, input_mask=None, generator=None) -> (tokens
    [b, max_decode_len], done [b])``.

    ``temperature == 0`` is greedy argmax; ``> 0`` samples from the scaled
    softmax with ``generator`` (a ``torch.Generator`` on the inputs'
    device; the reference takes a jax key).  Sequences emit EOS then pad;
    ``done`` marks rows that finished within the budget.  Every call runs
    all ``max_decode_len`` decoder passes."""
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")

    def pick(logits, generator):
        if temperature == 0.0:
            return logits.argmax(dim=-1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    def fn(params, inputs, input_mask=None, generator=None):
        if temperature > 0.0 and generator is None:
            raise ValueError("sampling (temperature > 0) requires a generator")
        cache, encoded, logits0 = prefill_decode(
            model, params, inputs, input_mask, max_decode_len, pad_id
        )
        tok = pick(logits0, generator)
        finished = tok == eos_id
        out = [tok]
        for t in range(1, max_decode_len):
            cache, logits = _decode_one(
                model, params, cache, tok, encoded, input_mask, t,
                max_decode_len,
            )
            tok = torch.where(finished, pad_id, pick(logits, generator))
            finished = finished | (tok == eos_id)
            out.append(tok)
        return torch.stack(out, dim=1).to(torch.int32), finished

    return fn


def make_beam_generate(
    model: T5,
    *,
    beam_size: int = 4,
    max_decode_len: int = 32,
    eos_id: int = 1,
    pad_id: int = 0,
    length_alpha: float = 0.6,
):
    """Beam search ``fn(params, inputs, input_mask=None) -> (tokens
    [b, max_decode_len], score [b])``.

    Freeze-in-place beams: a finished beam may only emit pad at zero added
    log-prob, so its score is frozen while it stays a candidate; one top-k
    over ``beam_size * vocab`` per step.  The final choice maximizes
    ``logp / ((5 + len) / 6) ** alpha`` (the GNMT length penalty).  The
    encoder and the step-0 pass run once per row and are tiled across the
    beams (flat ``batch * beam`` rows, beam j of row i at ``i * k + j``);
    each step reorders the self-attention cache with one ``index_select``
    per leaf, and skips the cross-attention leaves, which are the same for
    every beam of a row."""

    def fn(params, inputs, input_mask=None):
        b, k = inputs.shape[0], beam_size
        cache, encoded, logits0 = prefill_decode(
            model, params, inputs, input_mask, max_decode_len, pad_id
        )
        flat_encoded = encoded.repeat_interleave(k, dim=0)
        flat_enc_mask = (None if input_mask is None
                         else input_mask.repeat_interleave(k, dim=0))
        device = logits0.device
        rows = torch.arange(b, device=device)[:, None]

        def reorder(cache, beam_idx):
            flat = (rows * k + beam_idx).reshape(-1)
            return {name: x if "cached_enc" in name else x.index_select(0, flat)
                    for name, x in cache.items()}

        vocab = logits0.shape[-1]
        # All beams share the step-0 distribution: one top-k over the row's
        # vocab picks the k distinct first tokens.
        logp, tok = torch.topk(torch.log_softmax(logits0.float(), dim=-1), k)
        cache = {name: x.repeat_interleave(k, dim=0) for name, x in cache.items()}
        finished = tok == eos_id
        lengths = torch.ones((b, k), dtype=torch.int32, device=device)
        tokens = torch.full((b, k, max_decode_len), pad_id, dtype=torch.long,
                            device=device)
        tokens[:, :, 0] = tok
        pad_only = torch.full((vocab,), -1e30, device=device)
        pad_only[pad_id] = 0.0                          # finished: pad, +0

        for t in range(1, max_decode_len):
            cache, logits = _decode_one(
                model, params, cache, tok.reshape(b * k), flat_encoded,
                flat_enc_mask, t, max_decode_len,
            )
            lp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, vocab)
            cand = logp[:, :, None] + torch.where(
                finished[:, :, None], pad_only, lp
            )
            logp, idx = torch.topk(cand.reshape(b, k * vocab), k)
            beam_idx = idx // vocab
            tok = idx % vocab
            cache = reorder(cache, beam_idx)
            was_finished = finished.gather(1, beam_idx)
            lengths = lengths.gather(1, beam_idx) + (~was_finished).to(torch.int32)
            finished = was_finished | (tok == eos_id)
            tokens = tokens[rows, beam_idx]
            tokens[:, :, t] = torch.where(was_finished, pad_id, tok)
        penalty = ((5.0 + lengths.float()) / 6.0) ** length_alpha
        score = logp / penalty                          # [b, k]
        best = score.argmax(dim=1)
        row = torch.arange(b, device=device)
        return tokens[row, best].to(torch.int32), score[row, best]

    return fn
