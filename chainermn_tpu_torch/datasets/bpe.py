"""Pure-Python byte-level BPE tokenizer: the port's own copy of the JAX
package's ``datasets/bpe.py``.

It is host-side Python with no JAX in it, so the port keeps it line for
line: the same chunking, the same merge rule and tie-break, the same
encoding and the same ``bpe.json`` (format ``chainermn_tpu-bpe-v1``).
The same bytes therefore give the same merges and the same ids in both
packages, and a ``bpe.json`` written by either loads in the other.

Design — byte-level BPE (the GPT-2 family's scheme, minus the
regex-table complexity):

- ids ``0..255`` are the raw bytes, so any input round-trips exactly
  (no unknown-token case, no normalisation step to get wrong);
- merge ``i`` creates id ``256 + i`` whose byte expansion is the
  concatenation of its parts: ``decode`` is a table lookup and a join;
- merges never cross a whitespace-chunk boundary (``\\s*\\S+`` or a
  whitespace run), which keeps the pair statistics linguistic rather
  than spanning ``word1 word2`` junctions, and makes encoding cacheable
  per chunk.
"""

from __future__ import annotations

import json
import re
from collections import Counter, defaultdict

__all__ = ["BPETokenizer", "train_bpe"]

_CHUNK = re.compile(rb"\s*\S+|\s+")


def _merge_pair(seq, pair, new_id):
    """Replace every left-to-right occurrence of adjacent ``pair`` in
    ``seq`` with ``new_id`` — the one replacement rule both encoding
    and training must share exactly (a divergence would make encoding
    disagree with the statistics training computed)."""
    out, j = [], 0
    while j < len(seq):
        if j < len(seq) - 1 and (seq[j], seq[j + 1]) == pair:
            out.append(new_id)
            j += 2
        else:
            out.append(seq[j])
            j += 1
    return tuple(out)


class BPETokenizer:
    """Byte-level BPE encoder/decoder defined entirely by its merge
    list (rank = creation order, the standard BPE contract)."""

    def __init__(self, merges):
        self.merges = [tuple(m) for m in merges]
        self.ranks = {p: i for i, p in enumerate(self.merges)}
        self._expand = {i: bytes([i]) for i in range(256)}
        for i, (a, b) in enumerate(self.merges):
            if a not in self._expand or b not in self._expand:
                raise ValueError(
                    f"merge {i} = ({a}, {b}) references an id not yet "
                    "defined — merges must be in creation order")
            self._expand[256 + i] = self._expand[a] + self._expand[b]
        self._cache: dict[bytes, tuple[int, ...]] = {}

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges)

    # natural-language chunks (pre-tokenizer word pieces) are short and
    # highly repetitive, so the memo stays tiny; the cap only matters
    # for adversarial input (e.g. a stream of unique long chunks, where
    # the O(len^2) merge scan below would otherwise also pin unbounded
    # memory behind it).  At the cap the OLDEST entry is evicted (dict
    # preserves insertion order) instead of freezing insertion forever:
    # after an adversarial flood of unique chunks passes, steady-state
    # hot chunks re-enter the cache rather than paying the merge scan
    # on every encode for the rest of the process's life.
    _CACHE_CAP = 1 << 16

    def _encode_chunk(self, chunk: bytes) -> tuple[int, ...]:
        got = self._cache.get(chunk)
        if got is not None:
            return got
        word = tuple(chunk)
        while len(word) > 1:
            best_rank, best_pair = None, None
            for p in zip(word, word[1:]):
                r = self.ranks.get(p)
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_pair = r, p
            if best_pair is None:
                break
            word = _merge_pair(word, best_pair, 256 + best_rank)
        if len(self._cache) >= self._CACHE_CAP:
            self._cache.pop(next(iter(self._cache)))
        self._cache[chunk] = word
        return word

    def encode(self, text) -> list[int]:
        """``str`` (UTF-8-encoded first) or ``bytes`` -> token ids."""
        if isinstance(text, str):
            text = text.encode("utf-8")
        ids: list[int] = []
        for chunk in _CHUNK.findall(text):
            ids.extend(self._encode_chunk(chunk))
        return ids

    def decode(self, ids) -> bytes:
        """Token ids -> bytes.  Ids beyond the vocab (a model whose
        head is padded wider than the tokenizer can emit them early in
        training) decode to the empty string rather than raising —
        generation output should always be printable."""
        return b"".join(self._expand.get(int(i), b"") for i in ids)

    def decode_text(self, ids, errors: str = "replace") -> str:
        return self.decode(ids).decode("utf-8", errors=errors)

    def n_bytes(self, ids) -> int:
        """Byte length of the decoded ids — the denominator for
        bits-per-byte / byte-perplexity reporting, which is how a
        subword model's held-out number stays comparable to a
        byte-level baseline's."""
        return sum(len(self._expand.get(int(i), b"")) for i in ids)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"format": "chainermn_tpu-bpe-v1",
                       "vocab_size": self.vocab_size,
                       "merges": [list(p) for p in self.merges]}, f)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            obj = json.load(f)
        tok = cls(obj["merges"])
        if obj.get("vocab_size") not in (None, tok.vocab_size):
            raise ValueError(
                f"{path}: recorded vocab_size {obj['vocab_size']} != "
                f"256 + {len(tok.merges)} merges")
        return tok


def train_bpe(data: bytes, vocab_size: int,
              min_frequency: int = 2) -> BPETokenizer:
    """Learn up to ``vocab_size - 256`` merges from ``data``.

    Classic corpus-level BPE on unique whitespace chunks weighted by
    frequency (the Sennrich formulation): pair counts live in a
    Counter, and each adopted merge re-counts only the chunks that
    contain it — O(unique chunks touched), not O(corpus), per merge.
    Stops early when no pair reaches ``min_frequency`` (merging
    singletons would just memorise the tail of the corpus).  Ties
    break deterministically (count, then pair ids) so identical input
    always yields identical merges — checkpoints depend on that.
    """
    if vocab_size <= 256:
        raise ValueError(
            f"vocab_size {vocab_size} must exceed 256 (the byte ids)")
    if not data:
        return BPETokenizer([])
    words = Counter(_CHUNK.findall(data))
    seqs = {w: tuple(w) for w in words}
    pair_counts: Counter = Counter()
    occ: defaultdict = defaultdict(set)
    for w, s in seqs.items():
        c = words[w]
        for p in zip(s, s[1:]):
            pair_counts[p] += c
            occ[p].add(w)

    merges: list[tuple[int, int]] = []
    while 256 + len(merges) < vocab_size and pair_counts:
        pair, n = max(pair_counts.items(), key=lambda kv: (kv[1], kv[0]))
        if n < min_frequency:
            break
        new_id = 256 + len(merges)
        merges.append(pair)
        for w in list(occ[pair]):
            s, c = seqs[w], words[w]
            for p in zip(s, s[1:]):
                pair_counts[p] -= c
                if pair_counts[p] <= 0:
                    del pair_counts[p]
                occ[p].discard(w)
            seqs[w] = s = _merge_pair(s, pair, new_id)
            for p in zip(s, s[1:]):
                pair_counts[p] += c
                occ[p].add(w)
    return BPETokenizer(merges)
