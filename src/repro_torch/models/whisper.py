"""Whisper-style encoder-decoder backbone.

A port of the JAX package's ``repro.models.whisper``.  The conv audio
frontend is a stub there and here: the caller gives precomputed frame
embeddings (B, n_frames, d).  The backbone: a bidirectional encoder with
learned positions (no rope), and a causal decoder with learned positions,
rope with ``rope_theta`` on its self attention on top of them (as the
reference does), cross-attention to the encoder's output and GELU MLPs;
RMSNorm throughout and a tied unembedding.

The encoder reruns on every forward, decode steps included, as the
reference's does.  Prefill positions are ``arange(S) %
max_target_positions``; decode reads ``pos_dec[cache_len]``, where the
reference's gather clamps an index past the table to its last row:
torch raises on such an index, so the port clamps explicitly (past
position ``max_target_positions - 1`` decode and prefill disagree in the
reference, and so they do here; ROADMAP Queue 3 item 11).

On a tensor-parallel mesh (``layout``, ``transformer``'s module
docstring) the encoder and the decoder run GQA split on heads and the
GELU MLP by column then by row, its whole ``b_out`` added once after the
sum over ``model``; the tied embedding is split on the vocab.  Each
stream is sequence-parallel where ``Layout.seq_parallel`` says so for its
own length (the encoder's frames, the decoder's tokens), and then each
rank adds the rows of ``pos_enc``/``pos_dec`` of its own positions.  The
encoder's output is made whole over ``model`` once for the decoder (the
frames gathered, or, whole already, marked for the sum of its gradient),
and every cross attention reads it.  Serving runs on the same layout,
the decoder's KV caches split as ``transformer``'s module docstring
says.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import attention, mlp
from repro_torch.models.common import (ParamDef, chunked_attention, matmul,
                                       rms_norm)
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.models.transformer import (StackedModel, _norm_def,
                                            layer_cache, stack_defs)


def enc_layer_defs(cfg):
    return {"ln1": _norm_def(cfg), "attn": attention.gqa_defs(cfg),
            "ln2": _norm_def(cfg), "ffn": mlp.gelu_defs(cfg)}


def dec_layer_defs(cfg):
    return {"ln1": _norm_def(cfg), "attn": attention.gqa_defs(cfg),
            "lnx": _norm_def(cfg), "xattn": attention.cross_defs(cfg),
            "ln2": _norm_def(cfg), "ffn": mlp.gelu_defs(cfg)}


def param_defs(cfg):
    return {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("model", None)),
        "pos_enc": ParamDef((cfg.n_audio_frames, cfg.d_model),
                            (None, None)),
        "pos_dec": ParamDef((cfg.max_target_positions, cfg.d_model),
                            (None, None)),
        "enc_layers": stack_defs(enc_layer_defs(cfg), cfg.encoder_layers),
        "enc_norm": _norm_def(cfg),
        "dec_layers": stack_defs(dec_layer_defs(cfg), cfg.n_layers),
        "final_norm": _norm_def(cfg),
    }


def decode_position(cfg, cache_len: int) -> int:
    """The row of ``pos_dec`` a decode step at ``cache_len`` reads: the
    reference's gather clamps to the last row."""
    return min(cache_len, cfg.max_target_positions - 1)


class EncDecModel(StackedModel):
    """The encoder-decoder of ``cfg`` over a state ({name: tensor},
    adopted without a copy); on the meta device without one.  Under remat
    (``transformer`` module docstring) each encoder layer and each
    decoder layer of the cache-less forward is a checkpoint."""

    def __init__(self, cfg, state: Optional[dict] = None, layout=None):
        super().__init__(cfg, param_defs(cfg), state, layout)

    def param_defs(self):
        return param_defs(self.cfg)

    def cache_defs(self, batch: int, s_max: int):
        return {"dec_layers": stack_defs(
            attention.gqa_cache_defs(self.cfg, batch, s_max),
            self.cfg.n_layers)}

    # -------- encoder

    def _sp(self, seq_len: int) -> bool:
        """Whether a stream of ``seq_len`` is sequence-parallel."""
        return self.layout is not None and \
            self.layout.seq_parallel(self.cfg, seq_len)

    def _seq_block(self, n: int) -> slice:
        """This rank's block of a sequence of ``n`` positions."""
        return self.layout.block_index((None, "model"), (1, n))[1]

    def _positions(self, h, rows, sp: bool):
        """``h`` (this rank's block of the sequence under ``sp``) plus its
        positions' ``rows`` of a table."""
        if sp:
            rows = rows[self._seq_block(rows.shape[0])]
        return h + rows[None]

    def encode(self, audio_embeds, mode="train"):
        """The encoder's states of ``audio_embeds`` (this rank's block of
        the frames where the encoder is sequence-parallel); under remat in
        train mode (``transformer`` module docstring)."""
        cfg = self.cfg
        lay = self.layout
        dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        h = audio_embeds.to(dt)
        n = h.shape[1]
        sp = self._sp(n)
        if sp:
            h = h[:, self._seq_block(n)]
        h = self._positions(h, self.pos_enc.to(h.dtype)[:n], sp)

        def run(h, a, b):
            for lp in self.enc_layers[a:b]:
                ln = tp.enter(rms_norm(h, lp["ln1"], cfg.norm_eps), lay, sp)
                q = attention._proj(ln, lp["attn"]["wq"])
                k = attention._proj(ln, lp["attn"]["wk"])
                v = attention._proj(ln, lp["attn"]["wv"])
                att = chunked_attention(q, k, v, causal=False,
                                        chunk=cfg.attn_chunk)
                h = h + tp.leave(attention._out(att, lp["attn"]["wo"]), lay,
                                 sp)
                ln2 = tp.enter(rms_norm(h, lp["ln2"], cfg.norm_eps), lay, sp)
                h = h + mlp.gelu_apply(lp["ffn"], ln2,
                                       self._leave(sp))
            return h

        h = self._run_layers(run, h, 0, len(self.enc_layers), mode, None)
        return rms_norm(h, self.enc_norm, cfg.norm_eps)

    # -------- decoder

    def _leave(self, sp: bool):
        """``tensor_parallel.leave`` of a region on this model's layout
        (None without one)."""
        if self.layout is None:
            return None
        return lambda y: tp.leave(y, self.layout, sp)

    def _embed(self, tokens, enc_out, mode, cache_len, sp=False):
        cfg = self.cfg
        if self.layout is None:
            h = F.embedding(tokens, self.embed).to(enc_out.dtype)
        else:
            h = tp.embed_lookup(tokens, self.embed, self.layout,
                                sp).to(enc_out.dtype)
        pos = self.pos_dec.to(h.dtype)
        if mode == "decode":
            return h + pos[decode_position(cfg, cache_len)][None, None]
        idx = torch.arange(tokens.shape[1], device=tokens.device) \
            % cfg.max_target_positions
        return self._positions(h, pos[idx], sp)

    def _dec_layer(self, lp, h, enc_out, mode, cache, cache_len, sp=False,
                   seq=None):
        cfg = self.cfg
        lay = self.layout
        ln = tp.enter(rms_norm(h, lp["ln1"], cfg.norm_eps), lay, sp)
        if mode == "decode":
            a, _ = attention.gqa_decode(lp["attn"], ln, cfg, cache,
                                        cache_len, seq=seq)
        else:
            a, _ = attention.gqa_full(lp["attn"], ln, cfg, cache=cache,
                                      seq=seq)
        h = h + tp.leave(a, lay, sp)
        lnx = tp.enter(rms_norm(h, lp["lnx"], cfg.norm_eps), lay, sp)
        h = h + tp.leave(attention.cross_apply(lp["xattn"], lnx, enc_out,
                                               cfg), lay, sp)
        ln2 = tp.enter(rms_norm(h, lp["ln2"], cfg.norm_eps), lay, sp)
        return h + mlp.gelu_apply(lp["ffn"], ln2, self._leave(sp))

    def decode_stack(self, tokens, enc_out, *, mode="train", caches=None,
                     cache_len=None, enc_sp=False):
        """The decoder over the encoder's states ``enc_out`` (this rank's
        block of the frames under ``enc_sp``): with ``caches``
        ({"dec_layers": ...}) a prefill or decode step that writes them,
        without them the train forward (under remat there).  Returns (the
        hidden states, the caches)."""
        lay = self.layout
        if caches is None:
            mode = "train"
        sp = self._sp(tokens.shape[1])
        seq, _ = self.cache_placement(caches)
        if lay is not None:
            # the encoder's output whole over model, once for every cross
            # attention: its frames gathered, or its gradient summed
            enc_out = tp.gather(enc_out, lay.model) if enc_sp \
                else tp.copy(enc_out, lay.model)
        h = self._embed(tokens, enc_out, mode, cache_len, sp)

        def run(h, a, b):
            for i in range(a, b):
                h = self._dec_layer(self.dec_layers[i], h, enc_out, mode,
                                    layer_cache(caches, "dec_layers", i),
                                    cache_len, sp, seq)
            return h

        return self._run_layers(run, h, 0, len(self.dec_layers), mode,
                                caches), caches

    def forward(self, tokens, *, audio_embeds, mode="train", caches=None,
                cache_len=None, return_hidden=False, **_):
        """tokens: (B, S) integers; ``audio_embeds`` (B, n_frames, d);
        ``cache_len`` a host int.  Returns (logits, or the final hidden
        states with ``return_hidden``, and the caches, updated in
        place); on a mesh as ``transformer.DecoderModel.forward``."""
        cfg = self.cfg
        enc_out = self.encode(audio_embeds, mode)
        h, _ = self.decode_stack(tokens, enc_out, mode=mode, caches=caches,
                                 cache_len=cache_len,
                                 enc_sp=self._sp(audio_embeds.shape[1]))
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        if return_hidden:
            return h, caches
        return self.unembed(h), caches

    def unembed(self, h):
        return self._logits(h, self.embed, True)

    def unembed_weights(self):
        return self.embed, True
