"""Deterministic ChaCha8 randomness source (host side).

Twin of `poulpy_tpu/hal/source.py`: the same ChaCha8Rng keystream (constant
"expand 32-byte k", 8 key words, 64-bit block counter from 0, stream 0),
consumed word by word in the same order, with the same refill rule
(`max(4, ceil(words/16))` fresh blocks, leftover words carried over), so
every draw equals the JAX package's bit for bit.

Every refill draws its blocks through the native host tier
(`native.chacha8_blocks`, C++), written straight into the source's buffer;
a failed build of that library raises.  `plain_keystream` is the numpy
version the tests hold it against: blocks generated word-major
(`[16, blocks]`, each state word a contiguous row) and at most
`_CHUNK_BLOCKS` at a time, so a draw of 10^8 words keeps its temporaries
bounded by the chunk.  Neither changes the stream.
"""

from __future__ import annotations

import numpy as np

from poulpy_tpu_torch import native

_CONSTANTS = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32)

MAXF64 = 9007199254740992.0  # 2^53

_CHUNK_BLOCKS = 1 << 20


def _rotl(x, n):
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _chacha_blocks(key_words: np.ndarray, counter: int, nblocks: int) -> np.ndarray:
    """ChaCha8 blocks `counter … counter+nblocks-1`, returned as [nblocks, 16]
    uint32 (the keystream in consumption order when flattened)."""
    counters = np.arange(counter, counter + nblocks, dtype=np.uint64)
    state = np.empty((16, nblocks), dtype=np.uint32)
    state[0:4] = _CONSTANTS[:, None]
    state[4:12] = key_words[:, None]
    state[12] = (counters & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    state[13] = (counters >> np.uint64(32)).astype(np.uint32)
    state[14:16] = 0
    x = state.copy()

    def qr(a, b, c, d):
        x[a] += x[b]
        x[d] = _rotl(x[d] ^ x[a], 16)
        x[c] += x[d]
        x[b] = _rotl(x[b] ^ x[c], 12)
        x[a] += x[b]
        x[d] = _rotl(x[d] ^ x[a], 8)
        x[c] += x[d]
        x[b] = _rotl(x[b] ^ x[c], 7)

    with np.errstate(over="ignore"):
        for _ in range(4):  # ChaCha8 = 4 double rounds
            qr(0, 4, 8, 12)
            qr(1, 5, 9, 13)
            qr(2, 6, 10, 14)
            qr(3, 7, 11, 15)
            qr(0, 5, 10, 15)
            qr(1, 6, 11, 12)
            qr(2, 7, 8, 13)
            qr(3, 4, 9, 14)
        x += state
    return x.T


def plain_keystream(key_words: np.ndarray, counter: int, nblocks: int,
                    out: np.ndarray | None = None) -> np.ndarray:
    """The plain version of `native.chacha8_blocks`: the same [nblocks, 16]
    uint32 blocks, `_CHUNK_BLOCKS` at a time, written into `out` when given."""
    if out is None:
        out = np.empty((nblocks, 16), dtype=np.uint32)
    for b0 in range(0, nblocks, _CHUNK_BLOCKS):
        nb = min(_CHUNK_BLOCKS, nblocks - b0)
        out[b0 : b0 + nb] = _chacha_blocks(key_words, counter + b0, nb)
    return out


class Source:
    """Deterministic pseudorandom source (a ChaCha8 keystream from a 32-byte seed)."""

    def __init__(self, seed: bytes | np.ndarray):
        seed = np.frombuffer(bytes(seed), dtype=np.uint8)
        if seed.size != 32:
            raise ValueError("Source seed must be 32 bytes")
        self._key = seed.view(np.uint32).copy()
        self._counter = 0
        self._buf = np.zeros(0, dtype=np.uint32)
        self._pos = 0

    # -- keystream ---------------------------------------------------------

    def _refill(self, min_words: int):
        nblocks = max(4, -(-min_words // 16))
        left = self._buf[self._pos :]
        buf = np.empty(left.size + 16 * nblocks, dtype=np.uint32)
        buf[: left.size] = left
        native.chacha8_blocks(self._key, self._counter, nblocks,
                              out=buf[left.size :].reshape(nblocks, 16))
        self._counter += nblocks
        self._buf = buf
        self._pos = 0

    def _take_u32(self, count: int) -> np.ndarray:
        if self._buf.size - self._pos < count:
            self._refill(count - (self._buf.size - self._pos))
        out = self._buf[self._pos : self._pos + count]
        self._pos += count
        return out

    # -- draws -------------------------------------------------------------

    def next_u32(self) -> int:
        return int(self._take_u32(1)[0])

    def next_u64(self) -> int:
        w = self._take_u32(2)
        return int(w[0]) | (int(w[1]) << 32)

    def u64_array(self, count: int) -> np.ndarray:
        w = self._take_u32(2 * count).reshape(count, 2).astype(np.uint64)
        return w[:, 0] | (w[:, 1] << np.uint64(32))

    def fill_bytes(self, count: int) -> bytes:
        words = self._take_u32(-(-count // 4))
        return words.tobytes()[:count]

    def new_seed(self) -> bytes:
        return self.fill_bytes(32)

    def branch(self) -> tuple[bytes, "Source"]:
        """An independent child source seeded from this stream."""
        seed = self.new_seed()
        return seed, Source(seed)

    def next_u64n(self, max_: int, mask: int) -> int:
        """Uniform u64 in [0, max_) by masked rejection."""
        x = self.next_u64() & mask
        while x >= max_:
            x = self.next_u64() & mask
        return x

    # -- vectorized samplers ----------------------------------------------

    def uniform_digits(self, base2k: int, shape) -> np.ndarray:
        """Balanced uniform digits in [-2^{k-1}, 2^{k-1}), int64."""
        count = int(np.prod(shape))
        u = self.u64_array(count) & np.uint64((1 << base2k) - 1)
        x = u.astype(np.int64) - (1 << (base2k - 1))
        return x.reshape(shape)

    def normal_f64(self, shape, sigma: float, bound: float) -> np.ndarray:
        """Rounded Box–Muller Gaussian with rejection beyond `bound`."""
        count = int(np.prod(shape))
        out = np.zeros(count, dtype=np.float64)
        need = np.arange(count)
        while need.size:
            m = need.size
            u = self.u64_array(2 * ((m + 1) // 2 * 2))
            f = (u & np.uint64((1 << 53) - 1)).astype(np.float64) / MAXF64
            f = f.reshape(-1, 2)
            u1 = np.maximum(f[:, 0], 1e-300)
            r = np.sqrt(-2.0 * np.log(u1)) * sigma
            theta = 2.0 * np.pi * f[:, 1]
            z = (r * np.cos(theta))[:m]
            out[need] = z
            need = need[np.abs(z) > bound]
        return np.rint(out).reshape(shape)

    def ternary_prob(self, shape, prob: float = 0.5) -> np.ndarray:
        """Ternary coefficients: 0 w.p. 1-prob, else ±1."""
        count = int(np.prod(shape))
        u = self.u64_array(count)
        f = (u & np.uint64((1 << 53) - 1)).astype(np.float64) / MAXF64
        sign = np.where((u >> np.uint64(63)).astype(np.int64) == 0, 1, -1)
        x = np.where(f < prob, sign, 0).astype(np.int64)
        return x.reshape(shape)

    def ternary_hw(self, n: int, hw: int) -> np.ndarray:
        """Fixed-Hamming-weight ternary vector: `hw` signs (±1) at the front,
        then a Fisher–Yates shuffle drawn with `next_u64n`."""
        x = np.zeros(n, dtype=np.int64)
        signs = self.u64_array(hw)
        x[:hw] = np.where((signs >> np.uint64(63)).astype(np.int64) == 0, 1, -1)
        for i in range(n - 1, 0, -1):
            j = self.next_u64n(i + 1, (1 << (i + 1).bit_length()) - 1)
            x[i], x[j] = x[j], x[i]
        return x

    def binary_prob(self, shape, prob: float = 0.5) -> np.ndarray:
        """Binary coefficients: 1 w.p. prob, else 0."""
        count = int(np.prod(shape))
        u = self.u64_array(count)
        f = (u & np.uint64((1 << 53) - 1)).astype(np.float64) / MAXF64
        return (f < prob).astype(np.int64).reshape(shape)

    def binary_block(self, n: int, block_size: int) -> np.ndarray:
        """Block-binary secret: in each block of `block_size`, one uniformly
        placed 1 or none (drawn from block_size + 1 outcomes)."""
        if n % block_size:
            raise ValueError(f"n={n} is not a multiple of block_size={block_size}")
        x = np.zeros(n, dtype=np.int64)
        mask = (1 << (block_size + 1).bit_length()) - 1
        for b in range(n // block_size):
            j = self.next_u64n(block_size + 1, mask)
            if j < block_size:
                x[b * block_size + j] = 1
        return x
