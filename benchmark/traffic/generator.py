"""The one traffic generator: protein sequences and masked-LM batches from a
mix file's parameters and the run's seed.

Lengths. A mix gives a log-normal length distribution (`median`, `sigma`
of the log, clipped to [`min`, `max`] residues). Every unit of work (a call
of `proteins` proteins, a step of `batch` proteins) holds the same lengths:
the distribution's quantiles at the midpoints (i + 0.5) / n, in an order
the seed shuffles. So every seed gives the same work, and the seed moves
only the order and the residues, which are drawn uniformly from `alphabet`.

Unit i of a run draws from its own stream (seed, i), so a unit's inputs do
not depend on how many units came before it.
"""

import statistics

import numpy as np

PAD, CLS, EOS, MASK = 1, 0, 2, 32
# the ESM alphabet's residue ids, in the order of its letters
ALPHABET = "LAGVSERTIDPKQNFYMHWC"


def quantile_lengths(spec, n):
    """The n midpoint quantiles of the mix's length distribution, sorted."""
    z = statistics.NormalDist()
    out = [spec["median"] * np.exp(spec["sigma"] * z.inv_cdf((i + 0.5) / n))
           for i in range(n)]
    return np.clip(np.rint(out), spec["min"], spec["max"]).astype(np.int64)


def unit_rng(seed, unit, stream=0):
    return np.random.default_rng([int(seed) % 2 ** 63, unit, stream])


def sequences(mix, seed, unit):
    """The proteins of unit `unit`: a list of residue strings."""
    spec, n = mix["lengths"], mix["proteins"]
    rng = unit_rng(seed, unit)
    lengths = rng.permutation(quantile_lengths(spec, n))
    letters = np.frombuffer(mix.get("alphabet", ALPHABET).encode(), np.uint8)
    codes = letters[rng.integers(0, len(letters), int(lengths.sum()))]
    cuts = np.cumsum(lengths)[:-1]
    return [c.tobytes().decode() for c in np.split(codes, cuts)]


def residue_ids(seq):
    table = np.zeros(128, np.int64)
    for i, c in enumerate(ALPHABET):
        table[ord(c)] = 4 + i
    return table[np.frombuffer(seq.encode(), np.uint8)]


def mlm_batch(mix, seed, unit):
    """Masked-LM batch `unit`: {"protein_tokens", "mlm_labels"} int32
    [batch, longest + 2]. Each protein is truncated at `max_protein_len`
    residues, framed by CLS and EOS and right-padded. The BERT rule picks
    each residue with probability `mask.select`; of those, `mask.mask`
    become <mask>, `mask.random` a residue drawn uniformly, and the rest
    stay; labels are -100 where nothing was picked."""
    seqs = sequences(mix, seed, unit)
    cut = mix["max_protein_len"]
    rows = [residue_ids(s)[:cut] for s in seqs]
    width = max(len(r) for r in rows) + 2
    tokens = np.full((len(rows), width), PAD, np.int32)
    for i, r in enumerate(rows):
        tokens[i, 0] = CLS
        tokens[i, 1:len(r) + 1] = r
        tokens[i, len(r) + 1] = EOS
    rule = mix["mask"]
    rng = unit_rng(seed, unit, stream=1)
    residue = tokens >= 4
    picked = (rng.random(tokens.shape) < rule["select"]) & residue
    r = rng.random(tokens.shape)
    masked = tokens.copy()
    masked[picked & (r < rule["mask"])] = MASK
    swap = picked & (r >= rule["mask"]) & (r < rule["mask"] + rule["random"])
    masked[swap] = rng.integers(4, 4 + len(ALPHABET), int(swap.sum()))
    labels = np.where(picked, tokens, -100).astype(np.int32)
    return {"protein_tokens": masked, "mlm_labels": labels}
