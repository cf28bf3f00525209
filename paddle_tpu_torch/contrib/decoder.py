"""Reusable beam-search decoder.

≙ paddle_tpu/contrib/decoder.py (reference
python/paddle/fluid/contrib/decoder/beam_search_decoder.py, a
BeamSearchDecoder state machine over DynamicRNN and LoD beam trees). The
beam is a fixed [B, K] axis and the whole decode is one StaticRNN over
max_len steps, as in the JAX package: beam survival is the `beam_search`
op, recurrent state follows the surviving beams through a one-hot batched
matmul (the same ops as the JAX package, so both build the same program),
and `gather_tree` unwinds the hypothesis tree at the end. Every step runs
on the device with no host read.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from .. import layers
from ..core.enforce import InvalidArgumentError, enforce


def gather_beams(x, parent):
    """Reorder the beam-major FLOAT state x [B, K, ...] by the parent
    indices [B, K]: one batched matmul by their one-hot [B, K, K];
    trailing dims are flattened around the matmul, so any state rank
    works."""
    enforce(x.dtype.is_floating_point,
            f"gather_beams reorders float states (got {x.dtype}); gather "
            f"integer state through the selected-ids path instead",
            exc=InvalidArgumentError)
    k = x.shape[1]
    # ids as [B, K, 1]: a bare [B, 1] (K=1) would be read as an index
    # column by the one_hot convention and squeeze the beam dim away
    onehot = layers.one_hot(layers.unsqueeze(parent, axes=[2]),
                            depth=k)                   # [B, K, K]
    tail = list(x.shape[2:])
    if len(tail) > 1:
        flat = layers.reshape(x, [0, k, -1])           # [B, K, prod(tail)]
        out = layers.matmul(onehot, flat)
        return layers.reshape(out, [0, k] + tail)
    return layers.matmul(onehot, x)


class BeamSearchDecoder:
    """Generic fixed-beam decoder.

    The caller supplies a `step_fn(states, prev_ids) -> (new_states, logp)`
    operating on beam-expanded variables: every state is [B, K, ...], the
    ids are [B, K], and logp must be [B, K, vocab] log-probabilities.
    `decode` drives it max_len steps, keeps the top beam_size hypotheses
    per step (end_id hypotheses are frozen by the beam_search op), and
    returns (sequences [B, max_len, K], scores [B, K]).
    """

    def __init__(self, beam_size: int, bos_id: int, eos_id: int,
                 max_len: int, name: str = "beam_decoder"):
        enforce(beam_size >= 1, "beam_size must be >= 1",
                exc=InvalidArgumentError)
        self.beam_size = beam_size
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.max_len = max_len
        self.name = name

    def expand_to_beams(self, state):
        """[B, H] -> [B, K, H] (replicate an encoder state per beam)."""
        return layers.expand(layers.unsqueeze(state, axes=[1]),
                             expand_times=[1, self.beam_size, 1])

    def decode(self, batch_ref, init_states: Dict[str, object],
               step_fn: Callable, init_ids=None) -> Tuple[object, object]:
        """batch_ref: any variable whose dim 0 is the batch (shapes for the
        id/score/driver tensors derive from it); init_states: name -> [B, K,
        ...] beam-expanded variables (see expand_to_beams); init_ids
        (optional [B, 1] int64 var): per-row FIRST token to condition on —
        every beam starts from it — instead of the constant bos_id."""
        K = self.beam_size
        if init_ids is not None:
            ids0 = layers.expand(init_ids, expand_times=[1, K])
        else:
            ids0 = layers.fill_constant_batch_size_like(
                batch_ref, shape=[-1, K], dtype="int64", value=self.bos_id)
        # beam 0 live, beams 1..K-1 muted so step 1 expands ONE hypothesis
        # instead of K copies of the same bos continuation
        mute = layers.fill_constant_batch_size_like(
            batch_ref, shape=[-1, K], dtype="float32", value=-1e9)
        live0 = layers.fill_constant_batch_size_like(
            batch_ref, shape=[-1, 1], dtype="float32", value=0.0)
        if K > 1:
            scores0 = layers.concat(
                [live0, layers.slice(mute, axes=[1], starts=[1], ends=[K])],
                axis=1)
        else:
            scores0 = live0

        dummy = layers.fill_constant_batch_size_like(
            batch_ref, shape=[-1, self.max_len, 1], dtype="float32",
            value=0.0)

        rnn = layers.StaticRNN(name=self.name)
        with rnn.step():
            rnn.step_input(dummy)                      # drives max_len steps
            mem = {n: rnn.memory(init=v) for n, v in init_states.items()}
            ids_prev = rnn.memory(init=ids0)
            sc_prev = rnn.memory(init=scores0)

            new_states, logp = step_fn(dict(mem), ids_prev)
            enforce(set(new_states) == set(init_states),
                    "step_fn must return the same state names it was given",
                    exc=InvalidArgumentError)
            sel_ids, sel_scores, parent = layers.beam_search(
                ids_prev, sc_prev, logp, beam_size=K, end_id=self.eos_id)
            for n, v in new_states.items():
                # greedy (K=1) has exactly one hypothesis: parent is
                # identically 0 and the beam gather is an identity that
                # would still read+rewrite every state (the KV caches!)
                # once per step — skip it
                rnn.update_memory(mem[n],
                                  v if K == 1 else gather_beams(v, parent))
            rnn.update_memory(ids_prev, sel_ids)
            rnn.update_memory(sc_prev, sel_scores)
            rnn.step_output(sel_ids)
            rnn.step_output(parent)
        ids_seq, parent_seq = rnn()                    # [B, T, K] each
        final_scores = rnn.final_memories()[len(init_states) + 1]
        seqs = layers.beam_search_decode(ids_seq, parent_seq)
        return seqs, final_scores
