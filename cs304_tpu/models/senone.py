"""Senones: state-level tying with phonetic decision trees.

The tying ladder so far operates on whole UNITS: generalized triphones
(`models/triphone.py`) merge acoustically-close triphone models, so two
contexts either share all states or none. The classical finer rung (Young
et al. 1994, "Tree-based state tying for high accuracy acoustic
modelling") ties individual STATES: for every (center phone, state index)
a binary decision tree over questions about the left/right context splits
the observed triphone states into equivalence classes — SENONES — and
every (unit, state) slot maps to the senone its contexts classify into.
Two triphones of one phone can then share their steady middle state while
keeping distinct onset/offset states, which unit-level tying cannot
express. Because classification runs on the CONTEXT (not on trained
parameters), unseen triphones route through the same trees and get proper
context-dependent senones — strictly better than backing off to the
monophone.

Device mapping: a senone assignment is just a state-tie map for the
embedded trainer (ContinuousTrainer(state_ties=...)) — statistics pool
per senone via one segment-sum inside the unchanged fused XLA program
(models/train_fused._pool_slots), so senone training costs the same
device program as untied training. Tree building itself is a tiny
host-side problem (hundreds of Gaussians), exactly where it belongs.

Question set: with no phonetician on staff, context classes are derived
from the data — agglomerative clustering over the trained monophone
acoustics yields a hierarchy of phone classes (every merge node is one
class; singletons included), the standard data-driven substitute for
hand-written phonetic question sets. Split criterion: the exact gain in
diagonal-Gaussian corpus log-likelihood, computed from per-(unit, state)
sufficient statistics (occupancy, mean, second moment) gathered in one
forced-alignment pass of the seed triphone models.

No reference equivalent (the reference ties nothing below the word
level); builds on models/triphone.py and the state-tie trainer plumbing.
"""
from __future__ import annotations

import json
import logging
import math
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from .hmm import WordHMM
from .lexicon import Lexicon, SILENCE_LABEL, compose_word_models
from .triphone import (
    split_triphone,
    train_triphone_models,
    triphone_lexicon,
    word_units_tri,
)

logger = logging.getLogger(__name__)

_LOG_2PI = math.log(2.0 * math.pi)
_VAR_FLOOR = 1e-5


# ---------------------------------------------------------------------------
# Per-(label, state) sufficient statistics from one forced-alignment pass
# ---------------------------------------------------------------------------

@dataclass
class SlotStats:
    """Occupancy / mean / diagonal second central moment per (label, state)
    under a Viterbi alignment of the given models."""

    labels: List[str]
    state_counts: Dict[str, int]
    counts: np.ndarray  # (L, S) frames aligned to each slot
    means: np.ndarray   # (L, S, D) sample means
    vars: np.ndarray    # (L, S, D) diagonal ML variances (floored)

    def stats_for(self, label: str, state: int):
        i = self.labels.index(label)
        return (
            float(self.counts[i, state]),
            self.means[i, state],
            self.vars[i, state],
        )


def collect_state_stats(
    models: Dict[str, WordHMM],
    expanded_features: Dict[tuple, Sequence[np.ndarray]],
    length_multiple: int = 32,
    cross_word: str = "exit_only",
) -> SlotStats:
    """One alignment pass (the trainer's E-step, no M-step) over the
    already-expanded corpus: transcript tuples of MODEL labels (e.g.
    triphone units with silence interleaved) -> per-slot occupancy, sample
    mean, and diagonal central variance."""
    from .train_continuous import (
        ContinuousTrainConfig,
        ContinuousTrainer,
        _centered_m2_pass,
        _stats_pass,
        _sentence_log_a,
    )
    import jax.numpy as jnp

    cfg = ContinuousTrainConfig(
        max_iterations=1, insert_silence=False, fused=False,
        silence_bootstrap=False, length_multiple=length_multiple,
        cross_word=cross_word,
    )
    tr = ContinuousTrainer(dict(models), cfg)
    batches = tr._prepare_batches(expanded_features)
    l, s, d = len(tr.labels), tr.s_max, tr.dim
    counts = np.zeros((l, s), np.float64)
    sums = np.zeros((l, s, d), np.float64)
    per_batch = []
    for item in batches:
        topo = item["topo"]
        means_sent = tr.means_g[topo.lab_of_state, topo.loc_of_state]
        covs_sent = tr.covs_g[topo.lab_of_state, topo.loc_of_state]
        log_a_sent = _sentence_log_a(topo, tr.log_a_g, cfg.cross_word)
        c, sm, _t, paths = _stats_pass(
            jnp.asarray(means_sent), jnp.asarray(covs_sent),
            jnp.asarray(log_a_sent),
            jnp.asarray(topo.lab_of_state), jnp.asarray(topo.loc_of_state),
            jnp.asarray(topo.pos_of_state),
            item["batch"], item["lengths"], l, s,
        )
        counts += np.asarray(c, np.float64)
        sums += np.asarray(sm, np.float64)
        per_batch.append(paths)
    means = (sums / np.maximum(counts, 1.0)[..., None]).astype(np.float32)
    m2 = np.zeros((l, s, d), np.float64)
    for item, paths in zip(batches, per_batch):
        topo = item["topo"]
        full = np.asarray(
            _centered_m2_pass(
                jnp.asarray(means),
                jnp.asarray(topo.lab_of_state), jnp.asarray(topo.loc_of_state),
                item["batch"], item["lengths"], paths, l, s,
            ),
            np.float64,
        )
        m2 += np.einsum("lsdd->lsd", full)
    variances = (m2 / np.maximum(counts, 1.0)[..., None]).astype(np.float32)
    variances = np.maximum(variances, _VAR_FLOOR)
    return SlotStats(
        labels=list(tr.labels),
        state_counts=dict(tr.state_counts),
        counts=counts.astype(np.float32),
        means=means,
        vars=variances,
    )


# ---------------------------------------------------------------------------
# Data-driven context questions
# ---------------------------------------------------------------------------

def phone_classes(
    monophones: Dict[str, WordHMM], max_classes: int | None = None
) -> List[Tuple[str, ...]]:
    """Data-driven phone-class question set: agglomerative (centroid
    linkage) clustering over the monophone state-mean vectors; EVERY merge
    node's member set is one class, plus all singletons — the standard
    substitute for a hand-written phonetic feature table. Silence is a
    legitimate context (word edges) and participates."""
    names = sorted(monophones)
    vecs = {n: np.asarray(monophones[n].means, np.float64).ravel()
            for n in names}
    # Dimension mismatch (different state counts) -> pad to the longest.
    width = max(v.size for v in vecs.values())
    for n, v in vecs.items():
        if v.size < width:
            vecs[n] = np.pad(v, (0, width - v.size))
    clusters: List[Tuple[Tuple[str, ...], np.ndarray]] = [
        ((n,), vecs[n]) for n in names
    ]
    classes: List[Tuple[str, ...]] = [c[0] for c in clusters]
    while len(clusters) > 1:
        best = None
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                dist = float(np.linalg.norm(clusters[i][1] - clusters[j][1]))
                if best is None or dist < best[0]:
                    best = (dist, i, j)
        _, i, j = best
        members = tuple(sorted(clusters[i][0] + clusters[j][0]))
        cent = (
            clusters[i][1] * len(clusters[i][0])
            + clusters[j][1] * len(clusters[j][0])
        ) / len(members)
        clusters[i] = (members, cent)
        del clusters[j]
        if len(members) < len(names):  # the full set can never split
            classes.append(members)
    if max_classes is not None:
        classes = classes[:max_classes]
    return classes


# ---------------------------------------------------------------------------
# Decision trees
# ---------------------------------------------------------------------------

def _pooled_ll(items: List[dict]) -> Tuple[float, float]:
    """(total count, diagonal-Gaussian log-likelihood of the pooled set).

    Pooled moments from per-item (n, mu, var): the exact corpus LL of one
    diagonal Gaussian fit to the union, computed without touching frames:
    LL = -n/2 * (sum_d log var_d + D * (1 + log 2pi))."""
    n = sum(it["n"] for it in items)
    if n <= 0:
        return 0.0, 0.0
    mu = sum(it["n"] * it["mu"] for it in items) / n
    ex2 = sum(it["n"] * (it["var"] + it["mu"] ** 2) for it in items) / n
    var = np.maximum(ex2 - mu * mu, _VAR_FLOOR)
    d = mu.shape[0]
    ll = -0.5 * n * (float(np.log(var).sum()) + d * (1.0 + _LOG_2PI))
    return float(n), ll


def _split_threshold(min_gain: float | None, n_node: float, dim: int) -> float:
    """The likelihood gain a split must clear. min_gain=None -> a BIC-style
    floor, 0.5 * (2*dim) * log(n): a split adds one diagonal Gaussian
    (mean + variance = 2*dim parameters), so gains below this are what
    overfitting to the node's own frames buys by chance. Splits driven by
    real context effects (coarticulation) clear it by orders of magnitude;
    on corpora with little coarticulation it correctly keeps states pooled
    (raise min_gain explicitly to prune harder — unit-idiosyncratic but
    context-uncorrelated variation can exceed any fixed floor)."""
    if min_gain is not None:
        return float(min_gain)
    return 0.5 * (2.0 * dim) * math.log(max(n_node, 2.0))


def _grow_tree(
    items: List[dict],
    classes: List[Tuple[str, ...]],
    max_leaves: int,
    min_gain: float | None,
    min_count: float,
) -> dict:
    """Greedy top-down likelihood-gain tree over one (phone, state) pool.

    items: [{unit, prev, nxt, n, mu, var}]. Returns the serialized tree:
    {"leaf": k} or {"side": "L"|"R", "class": idx, "yes": .., "no": ..}.
    Leaf ids index the final leaves in creation order. min_gain: absolute
    split floor, or None for the per-node BIC floor (_split_threshold)."""
    class_sets = [frozenset(c) for c in classes]

    def best_split(node_items):
        n_all, ll_all = _pooled_ll(node_items)
        best = None
        for ci, cls in enumerate(class_sets):
            for side, ctx_key in (("L", "prev"), ("R", "nxt")):
                yes = [it for it in node_items if it[ctx_key] in cls]
                no = [it for it in node_items if it[ctx_key] not in cls]
                if not yes or not no:
                    continue
                n_yes, ll_yes = _pooled_ll(yes)
                n_no, ll_no = _pooled_ll(no)
                if n_yes < min_count or n_no < min_count:
                    continue
                gain = ll_yes + ll_no - ll_all
                if best is None or gain > best[0]:
                    best = (gain, side, ci, yes, no)
        return best

    # Leaves as mutable dicts so splits rewrite them in place.
    root: dict = {"items": items}
    leaves = [root]
    while len(leaves) < max_leaves:
        candidates = []
        for pos, leaf in enumerate(leaves):
            if "split" not in leaf:
                leaf["split"] = best_split(leaf["items"])
            if leaf["split"] is None:
                continue
            gain = leaf["split"][0]
            n_node, _ = _pooled_ll(leaf["items"])
            dim = leaf["items"][0]["mu"].shape[0]
            if gain >= _split_threshold(min_gain, n_node, dim):
                # Deterministic tie-break: earliest-created leaf wins.
                candidates.append((gain, -pos, leaf))
        if not candidates:
            break
        gain, neg_pos, leaf = max(candidates, key=lambda c: c[:2])
        _, side, ci, yes, no = leaf.pop("split")
        yes_node: dict = {"items": yes}
        no_node: dict = {"items": no}
        leaf.clear()
        leaf.update({"side": side, "class": ci,
                     "yes": yes_node, "no": no_node})
        leaves.pop(-neg_pos)
        leaves.extend([yes_node, no_node])

    # Assign leaf ids and strip working fields.
    def finalize(node: dict, counter: List[int]):
        if "side" in node:
            finalize(node["yes"], counter)
            finalize(node["no"], counter)
            return {"side": node["side"], "class": node["class"],
                    "yes": node["yes"], "no": node["no"]}
        node.pop("split", None)
        node["leaf"] = counter[0]
        counter[0] += 1
        node.pop("items")
        return node

    counter = [0]
    finalize(root, counter)

    def strip(node: dict) -> dict:
        if "side" in node:
            return {"side": node["side"], "class": node["class"],
                    "yes": strip(node["yes"]), "no": strip(node["no"])}
        return {"leaf": node["leaf"]}

    return strip(root)


@dataclass
class SenoneTying:
    """The trained tying: per-(phone, state) trees + the question classes.

    Classification needs only a unit's CONTEXTS, so unseen triphones get
    proper senones (no monophone back-off for in-inventory phones)."""

    classes: List[Tuple[str, ...]]
    trees: Dict[str, dict]  # "phone/state" -> tree
    num_states: Dict[str, int]  # center phone -> state count
    senone_of: Dict[str, str] = field(default_factory=dict)  # observed

    def classify(self, unit: str, state: int) -> str:
        prev, cur, nxt = split_triphone(unit)
        key = f"{cur}/{state}"
        if key not in self.trees:
            raise KeyError(f"no senone tree for {key!r}")
        node = self.trees[key]
        while "side" in node:
            ctx = prev if node["side"] == "L" else nxt
            members = self.classes[node["class"]]
            node = node["yes"] if ctx in members else node["no"]
        return f"{cur}.{state}.{node['leaf']}"

    def num_senones(self) -> int:
        def leaves(node):
            if "side" in node:
                return leaves(node["yes"]) + leaves(node["no"])
            return 1

        return sum(leaves(t) for t in self.trees.values())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "classes": [list(c) for c in self.classes],
                    "trees": self.trees,
                    "num_states": self.num_states,
                    "senone_of": self.senone_of,
                },
                f, indent=1, sort_keys=True,
            )

    @classmethod
    def load(cls, path: str) -> "SenoneTying":
        with open(path) as f:
            raw = json.load(f)
        return cls(
            classes=[tuple(c) for c in raw["classes"]],
            trees=raw["trees"],
            num_states={k: int(v) for k, v in raw["num_states"].items()},
            senone_of=dict(raw["senone_of"]),
        )


def build_senone_tying(
    stats: SlotStats,
    monophones: Dict[str, WordHMM],
    max_per_state: int = 4,
    min_gain: float = 0.0,
    min_count: float = 8.0,
    questions: List[Tuple[str, ...]] | None = None,
) -> SenoneTying:
    """Grow one decision tree per (center phone, state index) over the
    observed triphone units' per-state statistics. max_per_state bounds the
    leaf count per tree (total senones <= phones * states * max_per_state);
    min_gain/min_count are the usual likelihood/occupancy split floors."""
    classes = phone_classes(monophones) if questions is None else questions
    by_phone_state: Dict[Tuple[str, int], List[dict]] = {}
    for i, label in enumerate(stats.labels):
        if label == SILENCE_LABEL or "-" not in label:
            continue
        prev, cur, nxt = split_triphone(label)
        for st in range(stats.state_counts[label]):
            by_phone_state.setdefault((cur, st), []).append({
                "unit": label, "prev": prev, "nxt": nxt,
                "n": float(stats.counts[i, st]),
                "mu": stats.means[i, st].astype(np.float64),
                "var": stats.vars[i, st].astype(np.float64),
            })
    trees: Dict[str, dict] = {}
    num_states: Dict[str, int] = {}
    senone_of: Dict[str, str] = {}
    tying = SenoneTying(classes=classes, trees=trees, num_states=num_states,
                        senone_of=senone_of)
    for (phone, st), items in sorted(by_phone_state.items()):
        trees[f"{phone}/{st}"] = _grow_tree(
            items, classes, max_per_state, min_gain, min_count
        )
        num_states[phone] = max(num_states.get(phone, 0), st + 1)
    for (phone, st), items in sorted(by_phone_state.items()):
        for it in items:
            senone_of[f"{it['unit']}/{st}"] = tying.classify(it["unit"], st)
    return tying


# ---------------------------------------------------------------------------
# Training + composition
# ---------------------------------------------------------------------------

def train_senone_models(
    monophones: Dict[str, WordHMM],
    labeled_features: Dict[object, Sequence[np.ndarray]],
    lexicon: Lexicon,
    max_per_state: int = 4,
    min_gain: float = 0.0,
    min_count: float = 8.0,
    seed_smooth_tau: float = 30.0,
    config=None,
    mesh=None,
) -> Tuple[Dict[str, WordHMM], SenoneTying, int]:
    """The senone pipeline: (1) MAP-smoothed seed pass estimates every
    observed triphone's acoustics, (2) one alignment pass of the seed
    models gathers per-(unit, state) statistics, (3) decision trees tie
    states into senones, (4) the units RETRAIN through the unchanged
    embedded trainer with the senone map as state_ties (statistics pool
    per senone inside the fused program) and per-center-phone
    transition_ties. Returns (unit models incl. silence, tying, retrain
    iterations). Tied slots end bitwise-shared across units."""
    from .train_continuous import ContinuousTrainConfig, ContinuousTrainer

    seed_units, _ = train_triphone_models(
        monophones, labeled_features, lexicon, smooth_tau=seed_smooth_tau,
    )
    train_words: Set[str] = set()
    for tr in labeled_features:
        train_words.update(list(tr) if isinstance(tr, str) else tr)
    tlex = triphone_lexicon(lexicon, sorted(train_words))
    expanded = {
        tlex.expand_transcript(tr): feats
        for tr, feats in labeled_features.items()
    }
    if len(expanded) != len(labeled_features):
        raise ValueError(
            "two transcripts expanded to the same triphone sequence — "
            "merge their utterance lists first"
        )
    stats = collect_state_stats(seed_units, expanded)
    tying = build_senone_tying(
        stats, monophones, max_per_state=max_per_state,
        min_gain=min_gain, min_count=min_count,
    )
    state_ties = {}
    transition_ties = {}
    for label in stats.labels:
        if label == SILENCE_LABEL:
            continue
        _, cur, _ = split_triphone(label)
        transition_ties[label] = cur
        for st in range(stats.state_counts[label]):
            state_ties[(label, st)] = tying.senone_of[f"{label}/{st}"]

    if config is None:
        config = ContinuousTrainConfig(max_iterations=5, cov_reg=0.1)
    if config.insert_silence:
        config = type(config)(**{**config.__dict__, "insert_silence": False})
    trainer = ContinuousTrainer(
        dict(seed_units), config, mesh=mesh,
        state_ties=state_ties, transition_ties=transition_ties,
    )
    iterations = trainer.train(expanded)
    models = trainer.models()
    logger.info(
        "senone training: %d units, %d senones, %d iterations",
        len(models) - 1, tying.num_senones(), iterations,
    )
    return models, tying, iterations


def senone_table(
    unit_models: Dict[str, WordHMM], tying: SenoneTying
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """senone name -> (mean, covariance) read off any owning trained unit
    (tied slots are bitwise-shared, so any owner is THE senone)."""
    table: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for key, name in tying.senone_of.items():
        if name in table:
            continue
        unit, st = key.rsplit("/", 1)
        if unit in unit_models:
            m = unit_models[unit]
            table[name] = (m.means[int(st)], m.covariances[int(st)])
    return table


def synthesize_unit(
    unit: str,
    tying: SenoneTying,
    table: Dict[str, Tuple[np.ndarray, np.ndarray]],
    unit_models: Dict[str, WordHMM],
    monophones: Dict[str, WordHMM],
) -> WordHMM:
    """A model for an UNSEEN triphone: every state's emission comes from
    its tree-classified senone (falling back to the center monophone's row
    only for senones no trained unit owns); transitions come from any
    trained unit of the center phone (they are transition-tied) or the
    monophone."""
    _, cur, _ = split_triphone(unit)
    if cur not in monophones:
        raise ValueError(f"unit {unit!r}: phone {cur!r} not in inventory")
    mono = monophones[cur]
    donor = next(
        (m for u, m in sorted(unit_models.items())
         if u != SILENCE_LABEL and "-" in u and split_triphone(u)[1] == cur),
        mono,
    )
    n = mono.num_states
    means = np.array(mono.means, copy=True)
    covs = np.array(mono.covariances, copy=True)
    for st in range(n):
        try:
            name = tying.classify(unit, st)
        except KeyError:
            continue  # phone never observed in context -> monophone row
        if name in table:
            means[st], covs[st] = table[name]
    return WordHMM(
        label=unit, means=means, covariances=np.array(covs, copy=True),
        log_a=np.array(donor.log_a, copy=True),
    )


def senone_unit_table(
    lexicon: Lexicon,
    unit_models: Dict[str, WordHMM],
    tying: SenoneTying,
    monophones: Dict[str, WordHMM],
    words: Sequence[str] | None = None,
    unseen: str = "backoff",
) -> Tuple[Dict[str, WordHMM], int]:
    """unit -> model for every triphone the lexicon needs: trained units
    verbatim; units absent from training materialize per ``unseen``:

    - "backoff" (default): the center monophone, the classical chain.
      This is the MEASURED default — on the round-4 senone ladder
      (benchmarks/phone_tier.py --senones, recorded in ROADMAP.md) the
      back-off OOV exact beats tree synthesis at every corpus scale
      tried (0.30-0.35 vs 0.05 anticipatory; 0.80-1.00 vs 0.35-0.70 at
      100 words): the trees extrapolate a context shift for phones whose
      held-out realization is closest to the context-free center.
    - "synthesize": build the unit from its tree-classified senones
      (synthesize_unit) — wins only when the corpus isolates the context
      cue the trees encode (tests/test_senone.py minimal pairs keep that
      capability pinned).

    Returns (table, count of unseen units materialized).
    """
    from .biphone import prefer_silence

    if unseen not in ("backoff", "synthesize"):
        raise ValueError(f"unknown unseen mode {unseen!r}")
    names = lexicon.words if words is None else list(words)
    units = {u for w in names for u in word_units_tri(lexicon[w])}
    table: Dict[str, WordHMM] = {}
    materialized = 0
    params = senone_table(unit_models, tying)
    for unit in sorted(units):
        if unit in unit_models:
            table[unit] = unit_models[unit]
        elif unseen == "synthesize":
            table[unit] = synthesize_unit(
                unit, tying, params, unit_models, monophones
            )
            materialized += 1
        else:
            _, cur, _ = split_triphone(unit)
            if cur not in monophones:
                raise ValueError(
                    f"unit {unit!r}: phone {cur!r} not in inventory"
                )
            m = monophones[cur]
            table[unit] = WordHMM(
                label=unit, means=np.array(m.means, copy=True),
                covariances=np.array(m.covariances, copy=True),
                log_a=np.array(m.log_a, copy=True),
            )
            materialized += 1
    prefer_silence(table, unit_models, monophones)
    return table, materialized


def compose_word_models_senone(
    lexicon: Lexicon,
    unit_models: Dict[str, WordHMM],
    tying: SenoneTying,
    monophones: Dict[str, WordHMM],
    words: Sequence[str] | None = None,
    unseen: str = "backoff",
) -> Dict[str, WordHMM]:
    """Per-word HMMs from senone-tied triphone units; unseen contexts
    back off to their center monophone by default, or synthesize through
    the decision trees with unseen="synthesize" (see senone_unit_table
    for the measurement behind the default)."""
    names = lexicon.words if words is None else list(words)
    table, _ = senone_unit_table(lexicon, unit_models, tying, monophones,
                                 names, unseen=unseen)
    return compose_word_models(triphone_lexicon(lexicon, names), table,
                               names)
