"""Drop-in scalar API with the reference's names and semantics
(counterpart of ``kmers_tpu/compat.py``).

Users of COMBINE-lab/kmers can port call sites one-to-one:

    from kmers_tpu_torch.compat import Kmer, CanonicalKmer

    km = Kmer.from_str("ACGTT")
    ck = CanonicalKmer.from_kmer(km)
    ck.append_base_u8(ord("G"))

These are the classes of the port's scalar model
(kmers_tpu_torch.oracle.numpy_ref), the same semantics as the JAX
package's compat layer bit for bit.  For throughput, move hot loops to the
batched ops (kmers_tpu_torch.ops / kmers_tpu_torch.parallel).
"""

from .oracle.numpy_ref import (
    MASK64,
    MASK_TABLE,
    CanonicalKmer,
    CanonicalKmerIterator,
    HashState,
    Kmer,
    MatchType,
    Orientation,
    SeqVector,
    SeqVectorSlice,
    complement_base,
    encode_binary,
    encode_binary_u8,
    hash_one,
    is_valid_nuc,
    lex_hash,
    lex_hash_state,
    mix_hash,
    mix_hash_state,
    minimizer_word,
    reverse_complement_word,
    sub_kmer_word,
    word_from_bytes,
    word_to_string,
)

__all__ = [
    "MASK64", "MASK_TABLE", "CanonicalKmer", "CanonicalKmerIterator",
    "HashState", "Kmer", "MatchType", "Orientation", "SeqVector",
    "SeqVectorSlice", "complement_base", "encode_binary", "encode_binary_u8",
    "hash_one", "is_valid_nuc", "lex_hash", "lex_hash_state", "mix_hash",
    "mix_hash_state", "minimizer_word", "reverse_complement_word",
    "sub_kmer_word", "word_from_bytes", "word_to_string",
]
