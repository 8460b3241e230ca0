"""Packed 2-bit sequence storage on the device (counterpart of
``kmers_tpu/ops/seqvector.py``; the reference's seq_vector.rs over
simple_sds::RawVector).

Base i sits at bits [2i mod 32] of 32-bit word i // 16, the reference's
little-endian order: its RawVector u64 word j is words[2j] | words[2j+1]
<< 32, so the npz and simple_sds files round-trip bit for bit with the
JAX package's.  Words live in an ``int64`` tensor holding the uint32
values, with the JAX package's word count (two spare zero words after a
``from_bytes``), so a saved file holds the same array in both packages.

An unaligned k-mer read (seq_vector.rs:96-99) is a 3-word funnel shift for
a whole array of positions (bit b = 2 pos, i = b >> 5, r = b & 31):

    lo = w[i] >> r | w[i+1] << (32 - r)      hi = w[i+1] >> r | w[i+2] << (32 - r)

A word index past the end reads 0xFFFFFFFF, the value ``jnp.take`` fills
in there, so a read that runs past the stored words gives the JAX
package's word (the k-mer mask drops those bits whenever the read stays
inside the sequence).  Positions are uint32 bit offsets as in the JAX
package: a sequence holds fewer than 2^31 bases.
"""

from __future__ import annotations

from typing import Callable, Iterator, Tuple

import numpy as np
import torch

from ..core import u64
from . import encoding

# the value a gather past the stored words reads (jnp.take's uint32 fill)
_FILL = 0xFFFFFFFF
# the JAX package's positions are int32
MAX_BASES = (1 << 31) - 1


def pack_ascii_to_words(ascii_u8: np.ndarray) -> np.ndarray:
    """Host-side pack: ASCII bytes -> uint32 words, 16 bases a word,
    LSB-first (any byte packs to (c >> 1) & 3 in the naive order)."""
    arr = np.asarray(ascii_u8, dtype=np.uint8)
    n = len(arr)
    internal = (arr.astype(np.uint32) >> 1) & 3
    codes = internal ^ (internal >> 1)
    n_words = (n + 15) // 16
    padded = np.zeros(n_words * 16, dtype=np.uint32)
    padded[:n] = codes
    shifts = np.arange(16, dtype=np.uint32) * 2
    return np.bitwise_or.reduce(padded.reshape(n_words, 16) << shifts,
                                axis=1).astype(np.uint32)


def unpack_words_to_codes(words: torch.Tensor, n_bases: int) -> torch.Tensor:
    """uint32 words (int64 values) -> per-base codes [n_bases] (int64)."""
    shifts = torch.arange(16, dtype=torch.int64, device=words.device) * 2
    codes = ((words.to(torch.int64)[:, None] & u64.LOW32) >> shifts) & 3
    return codes.reshape(-1)[:n_bases]


def gather_kmers(words: torch.Tensor, positions: torch.Tensor,
                 k: int) -> torch.Tensor:
    """get_kmer_u64 for a tensor of base positions as int64 words
    (seq_vector.rs:96-99), 1 <= k <= 32.

    words: uint32 values in an int64 tensor.  An index past the end reads
    0xFFFFFFFF (the JAX package's fill), so no spare words are needed."""
    if not 1 <= k <= 32:
        raise ValueError(f"gather_kmers takes 1 <= k <= 32, got k={k}")
    bit = (positions.to(torch.int64) << 1) & u64.LOW32
    wi = bit >> 5
    r = bit & 31
    n = words.shape[0]
    padded = torch.cat([words.to(torch.int64),
                        words.new_full((1,), _FILL, dtype=torch.int64)])
    w0, w1, w2 = (padded[torch.clamp(wi + j, max=n)] for j in range(3))
    # in int64 a shift by 32 (r == 0) moves every bit past the low 32,
    # which the mask drops: no special case for an aligned read
    lo = ((w0 >> r) | (w1 << (32 - r))) & u64.LOW32
    hi = ((w1 >> r) | (w2 << (32 - r))) & u64.LOW32
    return ((hi << 32) | lo) & u64.mask(2 * k)


def _positions(n: int, device) -> torch.Tensor:
    if n > MAX_BASES:
        raise ValueError(f"{n} positions: the JAX package's positions are "
                         f"int32 (at most {MAX_BASES})")
    return torch.arange(max(n, 0), dtype=torch.int32, device=device)


def _as_words(words) -> torch.Tensor:
    """An int64 tensor of uint32 word values, masked to 32 bits."""
    if not isinstance(words, torch.Tensor) or words.dtype != torch.int64:
        raise TypeError("words must be an int64 tensor of uint32 values")
    return words & u64.LOW32


def _host_words(words: torch.Tensor) -> np.ndarray:
    return words.cpu().numpy().astype(np.uint32)


class SeqVector:
    """A 2-bit packed sequence on a device with the reference's API.

    Packs on the host; reads are batched tensor ops on the words' device.
    The scalar accessors exist for API parity; the batched ``get_kmers``,
    ``all_kmers`` and ``minimizers`` are the intended use."""

    def __init__(self, words: torch.Tensor, n_bases: int):
        self.words = _as_words(words)
        self.n_bases = n_bases

    # -- constructors ---------------------------------------------------------

    @staticmethod
    def from_bytes(data: bytes, device="cuda") -> "SeqVector":
        words = pack_ascii_to_words(np.frombuffer(data, dtype=np.uint8))
        words = np.concatenate([words, np.zeros(2, dtype=np.uint32)])
        return SeqVector(torch.from_numpy(words.astype(np.int64)).to(device),
                         len(data))

    @staticmethod
    def from_str(data: str, device="cuda") -> "SeqVector":
        return SeqVector.from_bytes(data.encode(), device=device)

    @staticmethod
    def with_capacity(n_bases: int, device="cuda") -> "SeqVector":
        """An empty vector (seq_vector.rs:135-139); fill it with push_chars.
        The capacity is a hint, as in the JAX package."""
        del n_bases
        return SeqVector.from_bytes(b"", device=device)

    def push_chars(self, data: bytes) -> None:
        """Append bases (seq_vector.rs:141-161): pack only the new bases and
        OR them in at the bit boundary, a word-level funnel shift that never
        re-packs the stored bases.  Works on a host copy of the words, as
        the JAX package does."""
        if not data:
            return
        n = self.n_bases
        host = _host_words(self.words)
        used = (n + 15) // 16                 # words holding current bases
        nw = pack_ascii_to_words(np.frombuffer(data, dtype=np.uint8))
        total = n + len(data)
        out = np.zeros((total + 15) // 16 + 2, dtype=np.uint32)
        out[:used] = host[:used]
        r = 2 * (n % 16)
        if r == 0:
            out[used:used + len(nw)] = nw
        else:
            ext = np.zeros(len(nw) + 1, dtype=np.uint32)
            ext[:-1] |= nw << np.uint32(r)
            ext[1:] |= nw >> np.uint32(32 - r)
            out[used - 1:used - 1 + len(ext)] |= ext
        self.words = torch.from_numpy(out.astype(np.int64)).to(
            self.words.device)
        self.n_bases = total

    # -- accessors ------------------------------------------------------------

    def __len__(self) -> int:
        return self.n_bases

    def is_empty(self) -> bool:
        return self.n_bases == 0

    def get_kmers(self, positions: torch.Tensor, k: int) -> torch.Tensor:
        return gather_kmers(self.words, positions, k)

    def get_kmer_u64(self, pos: int, k: int) -> int:
        """The k-mer at `pos` as an unsigned Python int."""
        if not 0 <= pos < self.n_bases:
            raise IndexError(f"position {pos} outside [0, {self.n_bases})")
        pos_t = torch.tensor([pos], dtype=torch.int32, device=self.words.device)
        return u64.to_ints(self.get_kmers(pos_t, k))[0]

    def get_base(self, pos: int) -> int:
        return self.get_kmer_u64(pos, 1)

    def all_kmers(self, k: int) -> Tuple[torch.Tensor, int]:
        """All len - k + 1 k-mer words (SeqVecKmerIterator's batch form,
        seq_vector.rs:260-300)."""
        n = self.n_bases - k + 1
        return self.get_kmers(_positions(n, self.words.device), k), n

    def iter_kmers(self, k: int) -> Iterator[Tuple[int, int]]:
        """(word, k) for each position, words as unsigned Python ints."""
        words, _ = self.all_kmers(k)
        for word in u64.to_ints(words):
            yield word, k

    def minimizers(self, k: int, w: int,
                   hash_fn: Callable[[torch.Tensor], torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(word, pos) of every k-mer's minimizer: the leftmost w-mer of
        least hash among its k - w + 1 (minimizers.rs:97-142); hash_fn is
        one of the port's ops.hash functions on int64 words."""
        from .minimizer import minimizer_stream_from_words

        n_pos = self.n_bases - w + 1
        wmers = self.get_kmers(_positions(n_pos, self.words.device), w)
        word, mpos = minimizer_stream_from_words(wmers, n_pos, k, w, hash_fn)
        n_kmers = self.n_bases - k + 1
        return word[:n_kmers], mpos[:n_kmers]

    def iter_minimizers(self, k: int, w: int,
                        hash_fn) -> Iterator[Tuple[int, int]]:
        """(word, pos) per k-mer as Python ints."""
        word, pos = self.minimizers(k, w, hash_fn)
        yield from zip(u64.to_ints(word), pos.tolist())

    def to_string(self) -> str:
        codes = unpack_words_to_codes(self.words, self.n_bases)
        return bytes(encoding.codes_to_ascii(codes, lower=False)
                     .cpu().numpy()).decode()

    def __str__(self) -> str:
        return self.to_string()

    def as_slice(self) -> "SeqVectorSlice":
        return SeqVectorSlice(self, 0, self.n_bases)

    def slice(self, start: int, end: int) -> "SeqVectorSlice":
        if not start <= end <= self.n_bases:
            raise ValueError(f"slice [{start}, {end}) of {self.n_bases} bases")
        return SeqVectorSlice(self, start, end - start)

    # -- checkpoint (npz) -------------------------------------------------------

    def save(self, path: str) -> None:
        """The JAX package's endian-stable npz: little-endian uint32 words
        and the base count."""
        np.savez(path, words=_host_words(self.words).astype("<u4"),
                 n_bases=np.int64(self.n_bases))

    @staticmethod
    def load(path: str, device="cuda") -> "SeqVector":
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            words = z["words"].astype(np.int64)
            n_bases = int(z["n_bases"])
        return SeqVector(torch.from_numpy(words).to(device), n_bases)

    # -- simple_sds interop (the reference's serialized format) ----------------
    #
    # simple-sds writes a RawVector as u64 LE: length in bits, u64 LE:
    # number of data words, then the u64 LE words, bits LSB-first; an
    # IntVector as u64 LE element count, u64 LE width, then a RawVector.
    # Our uint32 word pairs (lo, hi) are those u64 words.

    def to_simple_sds(self) -> bytes:
        """Serialize as a simple_sds RawVector byte stream."""
        n_bits = 2 * self.n_bases
        n64 = (n_bits + 63) // 64
        w32 = np.zeros(2 * n64, dtype=np.uint32)
        host = _host_words(self.words)
        w32[:min(len(host), 2 * n64)] = host[:2 * n64]
        data64 = (w32[0::2].astype(np.uint64)
                  | (w32[1::2].astype(np.uint64) << np.uint64(32)))
        head = np.array([n_bits, n64], dtype="<u8")
        return head.tobytes() + data64.astype("<u8").tobytes()

    def save_simple_sds(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.to_simple_sds())

    @staticmethod
    def from_simple_sds(data: bytes, device="cuda") -> "SeqVector":
        """Deserialize a simple_sds RawVector (From<RawVector>: the bit
        length must be even, seq_vector.rs:244-249)."""
        n_bits, n64 = (int(v) for v in np.frombuffer(data[:16], dtype="<u8"))
        if n_bits % 2 != 0:
            raise ValueError("RawVector bit length must be even "
                             "(seq_vector.rs:245)")
        if n64 != (n_bits + 63) // 64:
            raise ValueError("corrupt RawVector: word count mismatch")
        d64 = np.frombuffer(data[16:16 + 8 * n64], dtype="<u8")
        if len(d64) != n64:
            raise ValueError("truncated RawVector data")
        w32 = np.zeros(2 * n64 + 2, dtype=np.int64)   # +2 spare funnel words
        w32[0:2 * n64:2] = d64 & np.uint64(0xFFFFFFFF)
        w32[1:2 * n64:2] = d64 >> np.uint64(32)
        return SeqVector(torch.from_numpy(w32).to(device), n_bits // 2)

    @staticmethod
    def load_simple_sds(path: str, device="cuda") -> "SeqVector":
        with open(path, "rb") as f:
            return SeqVector.from_simple_sds(f.read(), device=device)

    @staticmethod
    def from_simple_sds_int_vector(data: bytes, device="cuda") -> "SeqVector":
        """Deserialize a simple_sds IntVector (From<IntVector>: the width
        must be 2, seq_vector.rs:251-258)."""
        n_elems, width = (int(v) for v in np.frombuffer(data[:16], dtype="<u8"))
        if width != 2:
            raise ValueError("IntVector width must be 2 (seq_vector.rs:252)")
        sv = SeqVector.from_simple_sds(data[16:], device=device)
        if sv.n_bases != n_elems:
            raise ValueError("corrupt IntVector: element count mismatch")
        return sv


class SeqVectorSlice:
    """A view of a SeqVector (seq_vector.rs:24-81): the same device words,
    the base offset applied at read time."""

    def __init__(self, sv: SeqVector, start_pos: int, length: int):
        if not (0 <= start_pos and 0 <= length
                and start_pos + length <= sv.n_bases):
            raise ValueError(f"slice of {length} bases at {start_pos} "
                             f"outside {sv.n_bases} bases")
        self.sv = sv
        self.start_pos = start_pos
        self.length = length

    def __len__(self) -> int:
        return self.length

    def is_empty(self) -> bool:
        return self.length == 0

    def get_kmers(self, positions: torch.Tensor, k: int) -> torch.Tensor:
        return self.sv.get_kmers(positions + self.start_pos, k)

    def get_kmer_u64(self, pos: int, k: int) -> int:
        if not pos + k <= self.length:
            raise IndexError(f"k-mer at {pos} (k={k}) past the slice's "
                             f"{self.length} bases")
        return self.sv.get_kmer_u64(pos + self.start_pos, k)

    def get_base(self, pos: int) -> int:
        return self.get_kmer_u64(pos, 1)

    def slice(self, start: int, end: int) -> "SeqVectorSlice":
        if not start <= end <= self.length:
            raise ValueError(f"slice [{start}, {end}) of {self.length} bases")
        return SeqVectorSlice(self.sv, self.start_pos + start, end - start)

    def iter_kmers(self, k: int) -> Iterator[Tuple[int, int]]:
        n = self.length - k + 1
        words = self.get_kmers(_positions(n, self.sv.words.device), k)
        for word in u64.to_ints(words):
            yield word, k

    def to_string(self) -> str:
        codes = unpack_words_to_codes(self.sv.words, self.sv.n_bases)
        codes = codes[self.start_pos:self.start_pos + self.length]
        return bytes(encoding.codes_to_ascii(codes, lower=False)
                     .cpu().numpy()).decode()

    def __str__(self) -> str:
        return self.to_string()


class SeqVecKmerIterator:
    """Name-parity iterator over all k-mers (seq_vector.rs:260-300):
    yields (word, k) like ``SeqVector.iter_kmers``, from one batched
    gather up front."""

    def __init__(self, sv: SeqVector, k: int):
        self.k = k
        words, self.n = sv.all_kmers(k)
        self._words = u64.to_ints(words)
        self._i = 0

    def __len__(self) -> int:
        return self.n

    def __iter__(self) -> "SeqVecKmerIterator":
        return self

    def __next__(self) -> Tuple[int, int]:
        if self._i >= self.n:
            raise StopIteration
        out = (self._words[self._i], self.k)
        self._i += 1
        return out


class SeqVecMinimizerIter:
    """Name-parity minimizer iterator (minimizers.rs:97-142): one
    MappedMinimizer per k-mer, the deque's output with its leftmost-tie
    rule, from one batched ``SeqVector.minimizers`` call."""

    def __init__(self, sv: SeqVector, k: int, w: int, hash_fn):
        word, pos = sv.minimizers(k, w, hash_fn)
        self._words = u64.to_ints(word)
        self._pos = pos.tolist()
        self.n = len(sv) - k + 1
        self._i = 0

    def __len__(self) -> int:
        return self.n

    def __iter__(self) -> "SeqVecMinimizerIter":
        return self

    def __next__(self):
        from .minimizer import MappedMinimizer

        if self._i >= self.n:
            raise StopIteration
        out = MappedMinimizer(word=self._words[self._i],
                              pos=self._pos[self._i])
        self._i += 1
        return out
