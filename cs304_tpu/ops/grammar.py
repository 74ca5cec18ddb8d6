"""Grammar-constrained composite Viterbi: decode under a word-level DFA.

Generalizes the word-count constraint (ops/viterbi_counted.py) to an
arbitrary deterministic finite automaton over the vocabulary: fixed-length
digit patterns with per-position alphabets (phone numbers, zip codes), finite
transcript sets (command menus), or any user-built DFA. The reference has no
equivalent — its only sequence-level knob is the flat inter-word penalty
swept corpus-wide (scripts/project5_find_trans_ndigits_*.py); composing the
trellis with an automaton enforces structure exactly, per utterance.

Device shape: the trellis state becomes (G, S) — grammar plane x composite
state. One time step is the same whole-array max-plus update as the
unconstrained scan; the cross move routes word-exit scores between planes
through the DFA's transition table with a one-hot max (G and the vocabulary
are tiny, so the (G, W, G) routing tensor is negligible next to the
emission work). Silence is grammar-transparent: its column is forced to the
identity, so silence can appear anywhere without advancing the automaton
(matching the decoder's skip_silence semantics and the counted trellis).

Entry seeding, the exits-over-self-loop tie order, and the reference
backtrace quirk follow ops/viterbi.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .viterbi_counted import _stay_matrix


@dataclass(frozen=True)
class WordDFA:
    """Deterministic word automaton over a composite's label list.

    next_state[g, w] is the plane reached by emitting word w (the index into
    ``labels``) from plane g, or -1 when w is not allowed there. Decoding
    starts in plane 0 and must END in an accepting plane. The silence label's
    column (if present) must be the identity — build through the helpers and
    it is enforced automatically.
    """

    next_state: np.ndarray  # (G, W) int32, -1 = disallowed
    accept: np.ndarray  # (G,) bool
    labels: List[str]  # composite word order (the decoder's labels)

    def __post_init__(self):
        ns = np.asarray(self.next_state)
        if ns.ndim != 2 or ns.shape[1] != len(self.labels):
            raise ValueError(
                f"next_state {ns.shape} does not match {len(self.labels)} labels"
            )
        if ns.max(initial=-1) >= ns.shape[0]:
            raise ValueError("next_state points past the last plane")
        if not np.asarray(self.accept).any():
            raise ValueError("grammar accepts nothing (no accepting plane)")

    @property
    def num_planes(self) -> int:
        return self.next_state.shape[0]

    # -- builders -------------------------------------------------------------
    @classmethod
    def from_positions(
        cls,
        position_sets: Sequence[Sequence[str]],
        labels: Sequence[str],
        silence: str = "S",
    ) -> "WordDFA":
        """Fixed-length pattern: position i must be one of position_sets[i].

        E.g. a 3-digit code whose first digit is 1-3:
        from_positions([("1","2","3"), all_digits, all_digits], labels).
        """
        labels = list(labels)
        n = len(position_sets)
        if n == 0:
            raise ValueError("empty pattern")
        g = n + 1
        next_state = np.full((g, len(labels)), -1, np.int32)
        for i, words in enumerate(position_sets):
            for word in words:
                if word == silence:
                    raise ValueError("silence cannot be a pattern position")
                next_state[i, _windex(labels, word)] = i + 1
        accept = np.zeros(g, bool)
        accept[n] = True
        return cls(_silence_identity(next_state, labels, silence), accept, labels)

    @classmethod
    def from_strings(
        cls, strings: Sequence[str], labels: Sequence[str], silence: str = "S"
    ) -> "WordDFA":
        """Finite transcript set as a trie DFA (command-menu decoding)."""
        labels = list(labels)
        strings = list(strings)
        if not strings:
            raise ValueError("empty string set")
        # Trie: node 0 is the root; nodes created on demand.
        next_state = [np.full(len(labels), -1, np.int32)]
        accept = [False]
        for text in strings:
            if not text:
                raise ValueError("empty transcript in the string set")
            node = 0
            for word in text:
                w = _windex(labels, word)
                if word == silence:
                    raise ValueError("silence cannot appear in a transcript")
                if next_state[node][w] < 0:
                    next_state[node][w] = len(next_state)
                    next_state.append(np.full(len(labels), -1, np.int32))
                    accept.append(False)
                node = int(next_state[node][w])
            accept[node] = True
        ns = np.stack(next_state)
        return cls(
            _silence_identity(ns, labels, silence),
            np.asarray(accept, bool),
            labels,
        )

    @classmethod
    def exact_count(
        cls,
        n_words: int,
        labels: Sequence[str],
        n_words_min: int | None = None,
        silence: str = "S",
    ) -> "WordDFA":
        """The word-count constraint as a grammar: between n_words_min
        (default n_words) and n_words words, any vocabulary order — the DFA
        equivalent of ops/viterbi_counted.py."""
        labels = list(labels)
        g = n_words + 1
        next_state = np.full((g, len(labels)), -1, np.int32)
        for plane in range(n_words):
            for w, label in enumerate(labels):
                if label != silence:
                    next_state[plane, w] = plane + 1
        accept = np.zeros(g, bool)
        lo = n_words if n_words_min is None else n_words_min
        accept[lo : n_words + 1] = True
        return cls(_silence_identity(next_state, labels, silence), accept, labels)


def _windex(labels: List[str], word: str) -> int:
    try:
        return labels.index(word)
    except ValueError:
        raise ValueError(
            f"grammar word {word!r} is not in the vocabulary {labels}"
        ) from None


def _silence_identity(next_state: np.ndarray, labels, silence: str) -> np.ndarray:
    if silence in labels:
        next_state = next_state.copy()
        next_state[:, labels.index(silence)] = np.arange(
            next_state.shape[0], dtype=np.int32
        )
    return next_state


@partial(jax.jit, static_argnames=("quirk_backtrace",))
def viterbi_composite_grammar(
    log_b, log_a, lower_of_state, is_entry, is_exit, word_of_state,
    next_state, accept, penalty, length=None, quirk_backtrace: bool = True,
):
    """Best path whose emitted word sequence the DFA accepts.

    next_state (G, W) int32 / accept (G,) bool as in WordDFA (the silence
    column must be the identity). Returns (score, path (T,) int32); score is
    -inf when no accepted path exists within the utterance length.
    """
    t_total, s = log_b.shape
    g, _w = next_state.shape
    if length is None:
        length = t_total
    length = jnp.asarray(length, jnp.int32)

    stay = _stay_matrix(log_a, lower_of_state, is_entry)
    penalty = jnp.asarray(penalty, log_b.dtype)
    # route[src_g, dst_g, w] = does emitting w from src_g land in dst_g?
    route = jax.nn.one_hot(next_state, g, dtype=bool, axis=1)  # (G, G, W)
    entry_word = word_of_state  # (S,) composite word index

    diag = jnp.diagonal(log_a)
    diag_init = jnp.where(jnp.isfinite(diag), diag, 0.0)
    # Seeding: starting inside word w at t=0 emits w once from plane 0.
    seed_plane = jax.nn.one_hot(
        next_state[0][entry_word], g, dtype=bool, axis=1
    ).T  # (G, S): True where plane == next_state[0, word_of_state]
    alpha0 = jnp.where(
        is_entry[None, :] & seed_plane, (log_b[0] + diag_init)[None, :], -jnp.inf
    )  # (G, S)

    gidx = jnp.arange(g, dtype=jnp.int32)[:, None]

    def step(alpha, inputs):
        t, log_b_t = inputs  # alpha (G, S)
        stay_scores = alpha[:, :, None] + stay[None, :, :]  # (G, S', S)
        stay_val = jnp.max(stay_scores, axis=1)
        stay_bp = jnp.argmax(stay_scores, axis=1).astype(jnp.int32)

        # Best exit per plane, routed through the DFA.
        exit_scores = jnp.where(is_exit[None, :], alpha, -jnp.inf)
        be = jnp.max(exit_scores, axis=1)  # (G,)
        be_idx = jnp.argmax(exit_scores, axis=1).astype(jnp.int32)
        routed = jnp.where(route, be[:, None, None], -jnp.inf)  # (G, G, W)
        src_best = jnp.max(routed, axis=0)  # (G_dst, W)
        src_plane = jnp.argmax(routed, axis=0).astype(jnp.int32)
        cross_val = jnp.where(
            is_entry[None, :], src_best[:, entry_word] + penalty, -jnp.inf
        )  # (G, S)
        cross_plane = src_plane[:, entry_word]  # (G, S)
        cross_state = be_idx[cross_plane]  # (G, S)

        # Exits win exact ties against the entry self-loop (the reference's
        # candidate order, hidden_markov_model.py:533-547).
        use_cross = cross_val >= stay_val
        new_alpha = jnp.maximum(stay_val, cross_val) + log_b_t[None, :]
        bp_state = jnp.where(use_cross, cross_state, stay_bp)
        bp_plane = jnp.where(use_cross, cross_plane,
                             jnp.broadcast_to(gidx, (g, s)))
        packed = (bp_plane * s + bp_state).astype(jnp.int32)

        live = t < length
        alpha = jnp.where(live, new_alpha, alpha)
        return alpha, packed

    ts = jnp.arange(1, t_total, dtype=jnp.int32)
    alpha_last, packs = jax.lax.scan(step, alpha0, (ts, log_b[1:]))
    backptrs = jnp.concatenate(
        [jnp.full((1, g, s), -1, jnp.int32), packs], axis=0
    )  # (T, G, S)

    final_exit = jnp.where(
        accept[:, None] & is_exit[None, :], alpha_last, -jnp.inf
    )  # (G, S)
    score = jnp.max(final_exit)
    flat = jnp.argmax(final_exit).astype(jnp.int32)

    def rev_step(packed_state, inputs):
        t, bp_t = inputs
        live = t <= length - 1
        emit = packed_state
        nxt = bp_t.reshape(-1)[packed_state]
        return jnp.where(live, nxt, packed_state), emit

    rts = jnp.arange(t_total - 1, 0, -1, dtype=jnp.int32)
    final_packed, emitted = jax.lax.scan(
        rev_step, flat, (rts, backptrs[t_total - 1 : 0 : -1])
    )
    packed_path = jnp.concatenate([jnp.array([final_packed]), emitted[::-1]])
    path = (packed_path % s).astype(jnp.int32)
    if quirk_backtrace:
        last = jnp.maximum(length - 1, 0)
        second = jnp.maximum(length - 2, 0)
        path = path.at[last].set(path[second])
    return score, path


def viterbi_composite_grammar_batch(
    log_b, log_a, lower_of_state, is_entry, is_exit, word_of_state,
    next_state, accept, penalty, lengths, quirk_backtrace: bool = True,
):
    """vmap of viterbi_composite_grammar over a padded batch."""
    fn = lambda b, l: viterbi_composite_grammar(
        b, log_a, lower_of_state, is_entry, is_exit, word_of_state,
        next_state, accept, penalty, l, quirk_backtrace=quirk_backtrace,
    )
    return jax.vmap(fn)(log_b, lengths)
