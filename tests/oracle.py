"""Brute-force pure-Python reference implementation used as a test oracle.

Implements CLARK semantics directly from the reference's formulas (scalar,
dict-based, slow) so the vectorized/device implementation can be checked against
an independent derivation.
"""

from __future__ import annotations

COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "U": "A",
        "a": "T", "c": "G", "g": "C", "t": "A", "u": "A", "N": "N"}
CODE = {"A": 0, "C": 1, "G": 2, "T": 3, "U": 3}


def enc_le(s: str) -> int:
    v = 0
    for i, ch in enumerate(s.upper()):
        v += CODE[ch] << (2 * i)
    return v


def revcomp(s: str) -> str:
    return "".join(COMP[c] for c in reversed(s))


def canonical(s: str) -> int:
    return min(enc_le(s.upper()), enc_le(revcomp(s).upper()))


def is_valid(ch: str) -> bool:
    return ch.upper() in "ACGTU"


def seq_kmers(seq: str, k: int):
    """All counted k-mer canonical values of one read sequence."""
    out = []
    for i in range(len(seq) - k + 1):
        w = seq[i : i + k]
        if all(is_valid(c) for c in w):
            out.append(canonical(w))
    return out


def nonoverlap_kmers(seq: str, k: int):
    """Light-mode scanner: non-overlapping k-mers, reset at invalid chars.
    Yields canonical values in completion order."""
    out = []
    run = []
    for ch in seq + "\x00":  # sentinel invalid to flush
        if is_valid(ch):
            run.append(ch)
            if len(run) == k:
                out.append(canonical("".join(run)))
                run = []
        else:
            run = []
    return out


def classify_read(db: dict[int, int], seq: str, k: int):
    """(total, index_best, best, s_best) per resultKernel semantics
    (CuClarkDB.cu:1361-1411): scan counts in ascending target order with
    strict > updates; indexBest = target index + 1."""
    counts: dict[int, int] = {}
    for v in seq_kmers(seq, k):
        lbl = db.get(v)
        if lbl is not None:
            counts[lbl] = counts.get(lbl, 0) + 1
    best = s_best = 0
    index_best = index_sbest = 0
    total = 0
    for t in sorted(counts):
        c = counts[t]
        if c > best:
            s_best = best
            index_sbest = index_best
            best = c
            index_best = t + 1
        elif c > s_best:
            s_best = c
            index_sbest = t + 1
        total += c
    return total, index_best, best, s_best, counts


def format_row(name, total, index_best, best, s_best, norm, k, names, counts=None, n_targets=None):
    ext = ""
    if counts is not None:
        ext = "".join(",%d" % counts.get(t, 0) for t in range(n_targets))
    denom = float(norm) - k + 1.0
    if denom == 0.0:
        # reads of length exactly k-1: C prints 0.0/0.0 as "-nan" (glibc)
        # and the assignment falls back to NA (engine._format_row_nan)
        return "%s%s,-nan,%s,%u,0" % (name, ext, names[0], best)
    gamma = float(total) / denom
    delta = float(best + s_best)
    conf = 0.0 if delta < 0.001 else float(best) / delta
    return "%s%s,%g,%s,%u,%g" % (name, ext, gamma, names[index_best], best, conf)


def build_db(targets: list[tuple[str, int]], k: int, light: bool = False,
             gap: int = 4, min_count_target: int = 0,
             label_names: list[str] | None = None) -> dict[int, int]:
    """targets: list of (concatenated-genome-string with records separated by
    '\\x00', label_index).  Returns canonical -> label for specific k-mers.

    Label-prefix multiplicity semantics included when label_names given.
    """
    first: dict[int, int] = {}
    mult: dict[int, int] = {}
    count: dict[int, int] = {}

    def pg(i):
        if label_names is None:
            return i
        s = label_names[i]
        return (len(s), s[:-1])

    for seq, lbl in targets:
        kmers = nonoverlap_kmers(seq, k) if light else seq_kmers(seq, k)
        if light:
            kmers = [v for j, v in enumerate(kmers) if j % gap == 0]
        for v in kmers:
            if v not in first:
                first[v] = lbl
                mult[v] = 1
                count[v] = 1
            else:
                l0 = first[v]
                mult[v] += (lbl != l0) + (pg(lbl) != pg(l0))
                count[v] = min(count[v] + 1, 254)
    return {
        v: first[v]
        for v in first
        if mult[v] == 1 and count[v] > min_count_target
    }


def rows(gen) -> list[str]:
    """Collect a classification row-chunk generator into a list of lines."""
    return b"".join(gen).decode().splitlines()
