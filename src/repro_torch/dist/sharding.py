"""Logical-axis sharding rules (the reference's ``dist/sharding.py``), as
data.

A ``Rules`` object maps *logical* array names ("w_q", "act_btd",
"kv_cache", ...) to a :class:`P`: one entry a dimension, each ``None``
(replicated), a mesh axis name, or a tuple of axis names (the dimension
cut over their product, row-major); dimensions past the last entry are
replicated.  The launch layer decides, per (arch × shape × mesh) cell,
which specs those names resolve to (``lm_rules``); ``NO_RULES`` is the
single-device table.

PyTorch has no counterpart of GSPMD's sharding constraints (the
reference's ``Rules.cs``), so nothing here acts on a tensor: the step
builders (``launch.steps``) read the table to cut parameters and inputs
(``dist.compat.shard_tree``) and to pick each path — the expert-parallel
MoE, the row-sharded tables, split-KV decode and the batch axes are
sharded; the layout-only rules (tensor-parallel dense weights,
Megatron-SP activations, 2-D FSDP of dense weights) are realised by
replication and listed in a step's ``meta["replicated"]``.
"""
from __future__ import annotations

from typing import Iterator, Mapping

__all__ = ["P", "Rules", "NO_RULES", "lm_rules", "spec_axes"]


class P(tuple):
    """A partition spec: ``P(None, "model")`` cuts dimension 1 over the
    "model" axis; ``P(("pod", "data"), None)`` cuts dimension 0 over both
    axes; ``P()`` replicates."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def spec_axes(entry) -> tuple[str, ...]:
    """The axis names of one spec entry: () for ``None``."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


class Rules(Mapping):
    """Immutable logical-name → :class:`P` table."""

    def __init__(self, specs: dict[str, P] | None = None):
        self._specs = dict(specs or {})

    def __getitem__(self, name: str) -> P:
        return self._specs[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._specs)

    def __len__(self) -> int:
        return len(self._specs)

    def get(self, name: str, default=None):
        return self._specs.get(name, default)

    def __repr__(self) -> str:
        return f"Rules({self._specs!r})"


NO_RULES = Rules({})


def lm_rules(batch_axes=(), tp: str = "model", sp: bool = False,
             resid_sp: bool = False, seq_kv_axes=(), w2d_axes=(),
             q_ok: bool = True, kv_ok: bool = True, ffn_ok: bool = True,
             vocab_ok: bool = True) -> Rules:
    """Rule table for the LM transformer family.

    Args:
      batch_axes: mesh axes carrying the global batch (DP); () replicates.
      tp:         the tensor-parallel mesh axis name.
      sp:         Megatron-SP — attention heads can't use the TP axis, so
                  shard the residual-stream *sequence* dim over it instead.
      resid_sp:   shard the residual sequence dim over TP even when heads
                  do shard (large-model activation relief).
      seq_kv_axes: axes for the KV-cache sequence dim (split-KV decode).
      w2d_axes:   axes for 2D weight sharding (FSDP over the d_model dim
                  on top of TP) — () disables.
      q_ok/kv_ok/ffn_ok/vocab_ok: whether heads / kv-heads / d_ff / vocab
                  divide the TP axis; a False drops TP on that dim.

    Logical names (ranks):
      w_q (d,H,hd)  w_kv (d,Hkv,hd)  w_o (H,hd,d)  w_ffn_in (d,f)
      w_ffn_out (f,d)  w_expert (L,E,d,f)  w_embed (V,d)
      tok_bt (B,T)  act_btd (B,T,d)  act_bthh (B,T,H,hd)  act_btf (B,T,f)
      logits_btv (B,T,V)  kv_cache (L,B,Smax,Hkv,hd)
    """
    ba = tuple(batch_axes) or None
    w2d = tuple(w2d_axes) or None
    t_q = tp if q_ok else None
    t_kv = tp if kv_ok else None
    t_ffn = tp if ffn_ok else None
    t_vocab = tp if vocab_ok else None
    seq_kv = tuple(seq_kv_axes) or None
    # residual-stream sequence sharding: explicit SP, or large-model
    # activation sharding; both use the (otherwise colliding) TP axis.
    act_seq = tp if (sp or resid_sp) else None
    return Rules({
        "w_q": P(w2d, t_q, None),
        "w_kv": P(w2d, t_kv, None),
        "w_o": P(t_q, None, w2d),
        "w_ffn_in": P(w2d, t_ffn),
        "w_ffn_out": P(t_ffn, w2d),
        # stacked expert tensors (L, E, d, f): E on TP/EP, d on FSDP axes —
        # must agree with the expert-parallel branch of models/lm/moe.py.
        "w_expert": P(None, tp, ba, None),
        "w_embed": P(t_vocab, w2d),
        "tok_bt": P(ba, None),
        "act_btd": P(ba, act_seq, None),
        "act_bthh": P(ba, None, t_q, None),
        "act_btf": P(ba, None, t_ffn),
        "logits_btv": P(ba, None, t_vocab),
        "kv_cache": P(None, ba, seq_kv, t_kv, None),
    })
