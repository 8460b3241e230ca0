"""The scalar model of the reference semantics (COMBINE-lab/kmers), the
port's own copy of what ``kmers_tpu/oracle/numpy_ref.py`` holds for the
compat layer and the generic layer.

Plain Python, deliberately scalar and slow: it pins the bit-level
contract and serves as the drop-in scalar API (``kmers_tpu_torch.compat``).
The port may not import the JAX package's copy (importing any module of
that package runs its ``__init__``, which imports JAX), so this file
repeats it, and the tests hold the two against each other.

Reference semantics reproduced here (citations into the reference crate):
  * base codes A=0, C=1, G=2, T=3, case-insensitive
    (src/naive_impl/mod.rs:19-50)
  * bit layout: base i of the sequence occupies bits [2i, 2i+1]; first base
    least significant (src/naive_impl/kmer.rs:219-223)
  * reverse complement: complement-all then 5-step swap ladder then shift
    (src/naive_impl/kmer.rs:124-136)
  * canonical = numerically smaller of (fw, rc) (src/naive_impl/kmer.rs:55-58,
    src/naive_impl/canonical_kmer.rs:103-119)
  * LexHasher = base-reversal ladder, order-preserving
    (src/naive_impl/hash.rs:51-72)
  * minimizer = leftmost argmin of hash over all k-w+1 windows
    (src/naive_impl/kmer.rs:164-192, src/naive_impl/seq_vector/minimizers.rs)
  * N-skipping iterator (src/naive_impl/canonical_kmer_iterator.rs:41-70)
  * MASK_TABLE[32] == 0 quirk (src/naive_impl/kmer.rs:584-618)
  * the 24 Naive permutation encodings and the storage word count of the
    generic layer (src/encoding/naive.rs:49-74, src/kmer.rs:67-69)
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

MASK64 = (1 << 64) - 1
INVALID = MASK64  # u64::MAX sentinel for invalid bases (mod.rs:40-50)

A, C, G, T = 0, 1, 2, 3

# MASK_TABLE[k]: lowest 2k bits set -- EXCEPT MASK_TABLE[32] == 0, replicating
# the reference's wrap-around quirk (naive_impl/kmer.rs:584-618).  from_u64 is
# therefore only usable for k <= 31, exactly as in the reference.
MASK_TABLE = [((1 << (2 * k)) - 1) & MASK64 for k in range(32)] + [0]

_ENCODE = {
    ord("A"): A, ord("a"): A,
    ord("C"): C, ord("c"): C,
    ord("G"): G, ord("g"): G,
    ord("T"): T, ord("t"): T,
}

BASE_TABLE = "acgt"  # lowercase display (naive_impl/kmer.rs:24)


def encode_binary_u8(c: int) -> int:
    """ASCII byte -> 2-bit code; INVALID sentinel otherwise (mod.rs:40-50)."""
    return _ENCODE.get(c, INVALID)


def encode_binary(c: str) -> int:
    """ASCII char -> 2-bit code; raises on invalid (mod.rs:27-37)."""
    b = _ENCODE.get(ord(c), INVALID)
    if b == INVALID:
        raise ValueError(f"cannot decode {c} into 2 bit encoding")
    return b


def complement_base(b: int) -> int:
    """3 - b (mod.rs:80-84)."""
    return 3 - b


def is_valid_nuc(b: int) -> bool:
    return b < 4


def word_from_bytes(s: bytes) -> int:
    """Pack ASCII bytes LSB-first; panics on invalid or len>32
    (naive_impl/kmer.rs:234-251)."""
    if len(s) > 32:
        raise ValueError("kmers longer than 32 bases not supported")
    w = 0
    for c in reversed(s):
        w = ((w << 2) | encode_binary(chr(c))) & MASK64
    return w


def word_to_string(w: int, k: int) -> str:
    """Decode low 2k bits, lowercase (naive_impl/kmer.rs:196-207)."""
    out = []
    for _ in range(k):
        out.append(BASE_TABLE[w & 3])
        w >>= 2
    return "".join(out)


def reverse_complement_word(w: int, k: int) -> int:
    """Complement-all + 5-step swap ladder + shift (naive_impl/kmer.rs:138-147)."""
    res = (~w) & MASK64
    res = ((res >> 2) & 0x3333333333333333) | ((res & 0x3333333333333333) << 2)
    res = ((res >> 4) & 0x0F0F0F0F0F0F0F0F) | ((res & 0x0F0F0F0F0F0F0F0F) << 4)
    res = ((res >> 8) & 0x00FF00FF00FF00FF) | ((res & 0x00FF00FF00FF00FF) << 8)
    res = ((res >> 16) & 0x0000FFFF0000FFFF) | ((res & 0x0000FFFF0000FFFF) << 16)
    res = ((res >> 32) & 0x00000000FFFFFFFF) | ((res & 0x00000000FFFFFFFF) << 32)
    res &= MASK64
    return res >> (2 * (32 - k))


def lex_hash(word: int, k: int) -> int:
    """LexHasher: base-reversal ladder (no complement), then shift
    (hash.rs:51-72).  Order-preserving w.r.t. the sequence string."""
    res = word & MASK64
    res = ((res >> 2) & 0x3333333333333333) | ((res & 0x3333333333333333) << 2)
    res = ((res >> 4) & 0x0F0F0F0F0F0F0F0F) | ((res & 0x0F0F0F0F0F0F0F0F) << 4)
    res = ((res >> 8) & 0x00FF00FF00FF00FF) | ((res & 0x00FF00FF00FF00FF) << 8)
    res = ((res >> 16) & 0x0000FFFF0000FFFF) | ((res & 0x0000FFFF0000FFFF) << 16)
    res = ((res >> 32) & 0x00000000FFFFFFFF) | ((res & 0x00000000FFFFFFFF) << 32)
    res &= MASK64
    return res >> ((32 - k) * 2)


def _mix32(x: int) -> int:
    """32-bit avalanche mixer (public-domain 'lowbias32' constants)."""
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    x ^= x >> 16
    return x


def mix_hash(word: int, seed: int = 0) -> int:
    """kmers_tpu's default 64-bit bucketing hash for k-mer words.

    The reference's default BuildHasher is Rust's RandomState (SipHash with a
    random key) -- not a stable cross-language target; the *contract* is only
    that the hash is a function of the raw u64 word (hash.rs:4-8).  We define
    a stable, seedable mixer built from 32-bit multiplies so it runs at full
    VPU rate on TPU (no 64-bit multiply emulation).  Oracle and device paths
    are bit-identical.
    """
    lo = word & 0xFFFFFFFF
    hi = (word >> 32) & 0xFFFFFFFF
    s_lo = seed & 0xFFFFFFFF
    s_hi = (seed >> 32) & 0xFFFFFFFF
    a = _mix32(lo ^ _mix32(hi ^ s_lo))
    b = _mix32(hi ^ _mix32(lo ^ s_hi ^ 0x9E3779B9))
    return ((b << 32) | a) & MASK64


class HashState:
    """Stand-in for Rust BuildHasher: a callable word->u64 hash."""

    def __init__(self, fn: Callable[[int], int]):
        self._fn = fn

    def hash_word(self, word: int) -> int:
        return self._fn(word) & MASK64


def lex_hash_state(k: int) -> HashState:
    """LexHasherState(k) (hash.rs:22-36)."""
    return HashState(lambda w: lex_hash(w, k))


def hash_one(state: HashState, kmer) -> int:
    """hash_one(state, x): build a hasher, hash x, finish (hash.rs:10-20).
    Accepts a Kmer (hashes only its data word, k excluded; hash.rs:4-8) or
    a raw u64 word -- the reference asserts both are equal
    (naive_impl/kmer.rs:545-558)."""
    word = kmer.data if hasattr(kmer, "data") else int(kmer)
    return state.hash_word(word)


def mix_hash_state(seed: int = 0) -> HashState:
    return HashState(lambda w: mix_hash(w, seed))


class Orientation(IntEnum):
    # IntEnum = the serde analog: values serialize as plain ints through
    # json/npz, mirroring the reference's serde derives
    # (naive_impl/kmer.rs:18, canonical_kmer.rs:7)
    # sic: reference spells it "NotCanononical" (naive_impl/kmer.rs:18-22)
    IsCanonical = 0
    NotCanonical = 1


class MatchType(IntEnum):
    NoMatch = 0
    IdentityMatch = 1
    TwinMatch = 2


@dataclasses.dataclass
class Kmer:
    """Mirror of naive_impl::Kmer {k: u8, data: u64} (naive_impl/kmer.rs:7-10)."""

    k: int = 0
    data: int = 0

    @staticmethod
    def from_u64(data: int, k: int) -> "Kmer":
        return Kmer(k=k, data=data & MASK_TABLE[k])

    @staticmethod
    def from_str(s) -> "Kmer":
        if isinstance(s, str):
            s = s.encode()
        return Kmer(k=len(s), data=word_from_bytes(s))

    def __str__(self) -> str:
        return word_to_string(self.data, self.k)

    def into_u64(self) -> int:
        return self.data

    # Ord on (k, data) -- derived lexicographic tuple order (kmer.rs:6)
    def _key(self):
        return (self.k, self.data)

    def __lt__(self, o):
        return self._key() < o._key()

    def __le__(self, o):
        return self._key() <= o._key()

    def to_reverse_complement(self) -> "Kmer":
        return Kmer(k=self.k, data=reverse_complement_word(self.data, self.k))

    def is_canonical(self) -> bool:
        return self <= self.to_reverse_complement()

    def orientation(self) -> Orientation:
        return Orientation.IsCanonical if self.is_canonical() else Orientation.NotCanonical

    def to_canonical(self) -> "Kmer":
        return Kmer(self.k, self.data) if self.is_canonical() else self.to_reverse_complement()

    def prepend_base(self, b: int) -> int:
        """Returns evicted high base (naive_impl/kmer.rs:91-95)."""
        r = (self.data >> (2 * self.k - 2)) & 0x3
        self.data = MASK_TABLE[self.k] & (((self.data << 2) | b) & MASK64)
        return r

    def append_base(self, b: int) -> int:
        """Returns evicted low base (naive_impl/kmer.rs:98-102)."""
        r = self.data & 0x3
        self.data = ((self.data >> 2) | ((b << (2 * self.k - 2)) & MASK64)) & MASK64
        return r

    def prepend_base_u8(self, c: int) -> int:
        r = (self.data >> (2 * self.k - 2)) & 0x3
        self.data = MASK_TABLE[self.k] & (((self.data << 2) | encode_binary_u8(c)) & MASK64)
        return r

    def append_base_u8(self, c: int) -> int:
        r = self.data & 0x3
        self.data = ((self.data >> 2) | ((encode_binary_u8(c) << (2 * self.k - 2)) & MASK64)) & MASK64
        return r

    def sub_kmer_word(self, pos: int, width: int) -> int:
        assert pos < self.k and pos + width <= self.k
        return (self.data >> (pos * 2)) & MASK_TABLE[width]

    def sub_kmer(self, pos: int, width: int) -> "Kmer":
        return Kmer.from_u64(self.sub_kmer_word(pos, width), width)

    def minimizer(self, width: int, state: HashState) -> Tuple["Kmer", int]:
        mm, off = minimizer_word(self.data, self.k, width, state)
        return Kmer.from_u64(mm, width), off


def sub_kmer_word(word: int, k: int, pos: int, width: int) -> int:
    assert pos < k and pos + width <= k
    return (word >> (pos * 2)) & MASK_TABLE[width]


def minimizer_word(word: int, k: int, width: int, state: HashState) -> Tuple[int, int]:
    """Brute-force leftmost argmin scan (naive_impl/kmer.rs:170-192)."""
    min_mmer = sub_kmer_word(word, k, 0, width)
    min_hash = MASK64
    offset = 0
    for pos in range(k - width + 1):
        mmer = sub_kmer_word(word, k, pos, width)
        h = state.hash_word(mmer)
        if h < min_hash:
            min_mmer, min_hash, offset = mmer, h, pos
    return min_mmer, offset


@dataclasses.dataclass
class CanonicalKmer:
    """Dual-strand pair (canonical_kmer.rs:14-18)."""

    fw: Kmer
    rc: Kmer

    @staticmethod
    def blank_of_size(k: int) -> "CanonicalKmer":
        # fw = 0, rc = u64::MAX (canonical_kmer.rs:21-29)
        return CanonicalKmer(fw=Kmer(k=k, data=0), rc=Kmer(k=k, data=MASK64))

    @staticmethod
    def from_u64(data: int, k: int) -> "CanonicalKmer":
        fw = Kmer.from_u64(data, k)
        return CanonicalKmer(fw=fw, rc=fw.to_reverse_complement())

    @staticmethod
    def from_str(s) -> "CanonicalKmer":
        fw = Kmer.from_str(s)
        return CanonicalKmer(fw=fw, rc=fw.to_reverse_complement())

    @staticmethod
    def from_kmer(km: Kmer) -> "CanonicalKmer":
        return CanonicalKmer(fw=Kmer(km.k, km.data), rc=km.to_reverse_complement())

    def swap(self) -> None:
        self.fw.data, self.rc.data = self.rc.data, self.fw.data

    def is_fw_canonical(self) -> bool:
        return self.fw.data < self.rc.data

    def append_base(self, b: int) -> int:
        r = self.fw.append_base(b)
        self.rc.prepend_base(complement_base(b))
        return r

    def prepend_base(self, b: int) -> int:
        r = self.fw.prepend_base(b)
        self.rc.append_base(complement_base(b))
        return r

    def append_base_u8(self, c: int) -> int:
        return self.append_base(encode_binary_u8(c))

    def prepend_base_u8(self, c: int) -> int:
        return self.prepend_base(encode_binary_u8(c))

    def get_canonical_kmer(self) -> Kmer:
        # strict <: on palindromes returns rc branch; same word either way
        # (canonical_kmer.rs:103-110)
        return Kmer(self.fw.k, self.fw.data) if self.fw.data < self.rc.data else Kmer(self.rc.k, self.rc.data)

    def get_canonical_word(self) -> int:
        return self.fw.data if self.fw.data < self.rc.data else self.rc.data

    def get_fw_mer(self) -> Kmer:
        return Kmer(self.fw.k, self.fw.data)

    def get_rc_mer(self) -> Kmer:
        return Kmer(self.rc.k, self.rc.data)

    def get_fw_word(self) -> int:
        return self.fw.data

    def get_rc_word(self) -> int:
        return self.rc.data

    def get_word_equivalency(self, other: int) -> MatchType:
        if self.fw.data == other:
            return MatchType.IdentityMatch
        if self.rc.data == other:
            return MatchType.TwinMatch
        return MatchType.NoMatch

    def get_kmer_equivalency(self, other: Kmer) -> MatchType:
        return self.get_word_equivalency(other.data)

    def __eq__(self, o) -> bool:
        return self.fw == o.fw and self.rc == o.rc

    def __str__(self) -> str:
        return str(self.get_canonical_kmer())


class CanonicalKmerIterator:
    """N-skipping iterator over an ASCII read
    (canonical_kmer_iterator.rs:32-116).

    Yields (via .get()) the CanonicalKmer and start position of each valid
    k-mer; windows containing an invalid char are skipped and iteration
    resumes after it.
    """

    def __init__(self, seq: bytes, k: int):
        self.seq = seq
        self.km = CanonicalKmer.blank_of_size(k)
        self.pos = -1
        self.invalid = False
        self.last_invalid = -1
        self.k = k
        self._find_next(-1, -1)

    def _find_next(self, ii: int, jj: int) -> None:
        i = ii + 1
        j = jj + 1
        for l in range(j, len(self.seq)):
            b = encode_binary_u8(self.seq[l])
            if b < 4:
                self.km.append_base(b)
                if (l - self.last_invalid) >= self.k:
                    self.pos = i
                    return
            else:
                self.last_invalid = l
                i = l + 1
        self.invalid = True

    def exhausted(self) -> bool:
        return self.invalid

    def inc(self) -> bool:
        lpos = self.pos + self.k
        self.invalid = self.invalid or (lpos >= len(self.seq))
        if not self.invalid:
            self._find_next(self.pos, lpos - 1)
        return not self.invalid

    def inc_by(self, count: int) -> bool:
        v = not self.invalid
        while count > 0 and v:
            v = self.inc()
            count -= 1
        return v

    def get(self):
        return self.km, self.pos

    def __iter__(self) -> Iterator[Tuple[int, int, int]]:
        """Iterate all (pos, fw_word, rc_word) of valid k-mers."""
        while not self.exhausted():
            yield self.pos, self.km.get_fw_word(), self.km.get_rc_word()
            self.inc()


def valid_kmer_positions(seq: bytes, k: int) -> List[Tuple[int, int, int]]:
    """All (pos, fw, rc) yielded by CanonicalKmerIterator -- the batch target."""
    return list(CanonicalKmerIterator(seq, k))


# ---------------------------------------------------------------------------
# SeqVector: 2-bit packed sequence (seq_vector.rs)
# ---------------------------------------------------------------------------

class SeqVector:
    """2-bit packed DNA container over 64-bit words (seq_vector.rs:18-22).

    Words are little-endian in base order: base i lives at bits [2i % 64] of
    word i // 32, matching simple_sds::RawVector layout.
    """

    def __init__(self, words: Optional[List[int]] = None, bit_len: int = 0):
        self.words: List[int] = list(words) if words else []
        self.bit_len = bit_len

    def __len__(self) -> int:
        return self.bit_len // 2

    def is_empty(self) -> bool:
        return self.bit_len == 0

    @staticmethod
    def from_bytes(data: bytes) -> "SeqVector":
        sv = SeqVector()
        for i in range(0, len(data), 32):
            chunk = data[i:i + 32]
            sv.words.append(word_from_bytes(chunk))
        sv.bit_len = len(data) * 2
        return sv

    def to_simple_sds(self) -> bytes:
        """simple_sds RawVector serialization: u64 LE bit length, u64 LE
        word count, u64 LE words (the reference's serde-compat on-disk
        layout; seq_vector.rs:18-22)."""
        n64 = (self.bit_len + 63) // 64
        words = (self.words + [0] * n64)[:n64]
        out = self.bit_len.to_bytes(8, "little") + n64.to_bytes(8, "little")
        return out + b"".join((w & MASK64).to_bytes(8, "little")
                              for w in words)

    @staticmethod
    def from_simple_sds(data: bytes) -> "SeqVector":
        bit_len = int.from_bytes(data[:8], "little")
        n64 = int.from_bytes(data[8:16], "little")
        assert bit_len % 2 == 0  # From<RawVector>, seq_vector.rs:245
        words = [int.from_bytes(data[16 + 8 * i:24 + 8 * i], "little")
                 for i in range(n64)]
        return SeqVector(words, bit_len)

    def push_chars(self, data: bytes) -> None:
        """Pushes len%32 head partial word then 32-base chunks
        (seq_vector.rs:141-161)."""
        first_len = len(data) % 32
        first, rest = data[:first_len], data[first_len:]
        if first:
            self._push_int(word_from_bytes(first), first_len * 2)
        for i in range(0, len(rest), 32):
            chunk = rest[i:i + 32]
            self._push_int(word_from_bytes(chunk), len(chunk) * 2)

    def _push_int(self, value: int, width: int) -> None:
        # simple_sds RawVector::push_int: append `width` bits LSB-first
        bit_pos = self.bit_len
        word_i, off = bit_pos // 64, bit_pos % 64
        while len(self.words) <= (bit_pos + width - 1) // 64:
            self.words.append(0)
        self.words[word_i] |= (value << off) & MASK64
        if off + width > 64:
            self.words[word_i + 1] |= value >> (64 - off)
        self.bit_len += width

    def get_kmer_u64(self, pos: int, k: int) -> int:
        """Unaligned 2k-bit read at bit 2*pos (seq_vector.rs:96-99)."""
        assert pos < len(self)
        bit = pos * 2
        word_i, off = bit // 64, bit % 64
        w = self.words[word_i] >> off
        if off and word_i + 1 < len(self.words):
            w |= (self.words[word_i + 1] << (64 - off)) & MASK64
        return w & (MASK64 if k == 32 else MASK_TABLE[k % 32] if k < 32 else (1 << (2 * k)) - 1)

    def get_kmer(self, pos: int, k: int) -> Kmer:
        return Kmer.from_u64(self.get_kmer_u64(pos, k), k)

    def get_base(self, pos: int) -> int:
        return self.get_kmer_u64(pos, 1)

    def __str__(self) -> str:
        # uppercase decode (seq_vector.rs:171-182)
        return "".join("ACGT"[self.get_base(i)] for i in range(len(self)))

    def as_slice(self) -> "SeqVectorSlice":
        return SeqVectorSlice(self, 0, len(self))

    def slice(self, start: int, end: int) -> "SeqVectorSlice":
        return self.as_slice().slice(start, end)

    def iter_kmers(self, k: int) -> Iterator[Kmer]:
        for pos in range(len(self) - k + 1):
            yield self.get_kmer(pos, k)

    def iter_minimizers(self, k: int, w: int, state: HashState) -> Iterator[Tuple[int, int]]:
        """Yield (word, pos) per k-mer -- deque-equivalent semantics
        (minimizers.rs:60-142): the minimizer of k-mer i is the leftmost
        w-mer with minimal hash among positions [i, i + k - w]."""
        n = len(self)
        assert n >= k
        n_kmers = n - k + 1
        wmers = [self.get_kmer_u64(p, w) for p in range(n - w + 1)]
        hashes = [state.hash_word(x) for x in wmers]
        for i in range(n_kmers):
            lo, hi = i, i + k - w
            best = lo
            for p in range(lo + 1, hi + 1):
                if hashes[p] < hashes[best]:
                    best = p
            yield wmers[best], best


class SeqVectorSlice:
    """Zero-copy view {len, start_pos, slice} (seq_vector.rs:24-81)."""

    def __init__(self, sv: SeqVector, start_pos: int, length: int):
        self.sv = sv
        self.start_pos = start_pos
        self.length = length

    def __len__(self) -> int:
        return self.length

    def is_empty(self) -> bool:
        return self.length == 0

    def get_kmer_u64(self, pos: int, k: int) -> int:
        assert pos < len(self)
        return self.sv.get_kmer_u64(pos + self.start_pos, k)

    def get_kmer(self, pos: int, k: int) -> Kmer:
        return Kmer.from_u64(self.get_kmer_u64(pos, k), k)

    def get_base(self, pos: int) -> int:
        return self.get_kmer_u64(pos, 1)

    def slice(self, start: int, end: int) -> "SeqVectorSlice":
        assert end <= len(self)
        return SeqVectorSlice(self.sv, self.start_pos + start, end - start)

    def __str__(self) -> str:
        return "".join("ACGT"[self.get_base(i)] for i in range(len(self)))

    def iter_kmers(self, k: int) -> Iterator[Kmer]:
        for pos in range(len(self) - k + 1):
            yield self.get_kmer(pos, k)

    def iter_minimizers(self, k: int, w: int, state: HashState) -> Iterator[Tuple[int, int]]:
        n = len(self)
        assert n >= k
        wmers = [self.get_kmer_u64(p, w) for p in range(n - w + 1)]
        hashes = [state.hash_word(x) for x in wmers]
        for i in range(n - k + 1):
            best = i
            for p in range(i + 1, i + k - w + 1):
                if hashes[p] < hashes[best]:
                    best = p
            yield wmers[best], best


# ---------------------------------------------------------------------------
# Generic encoding layer: the 24 Naive permutations (src/encoding/)
# ---------------------------------------------------------------------------

# The 24 Naive permutations, discriminant byte packs code-of-A in bits 6..8,
# C in 4..6, T in 2..4, G in 0..2 (encoding/naive.rs:49-74).
NAIVE_PERMS = {
    "ACTG": 0b00_01_10_11, "ACGT": 0b00_01_11_10, "ATCG": 0b00_10_01_11,
    "ATGC": 0b00_11_01_10, "AGCT": 0b00_10_11_01, "AGTC": 0b00_11_10_01,
    "CATG": 0b01_00_10_11, "CAGT": 0b01_00_11_10, "CTAG": 0b10_00_01_11,
    "CTGA": 0b11_00_01_10, "CGAT": 0b10_00_11_01, "CGTA": 0b11_00_10_01,
    "TACG": 0b01_10_00_11, "TAGC": 0b01_11_00_10, "TCAG": 0b10_01_00_11,
    "TCGA": 0b11_01_00_10, "TGAC": 0b10_11_00_01, "TGCA": 0b11_10_00_01,
    "GACT": 0b01_10_11_00, "GATC": 0b01_11_10_00, "GCAT": 0b10_01_11_00,
    "GCTA": 0b11_01_10_00, "GTAC": 0b10_11_01_00, "GTCA": 0b11_10_01_00,
}


def word_for_k(width_bits: int, k: int) -> int:
    """ceil(k / (bits/2)) (src/kmer.rs:67-69)."""
    per = width_bits // 2
    return (per + k - 1) // per
