"""Bit-exact Python port of the ChaCha RNG the reference simulator uses.

The synthetic cluster's stakes come from this stream (``synthetic_accounts``).

The reference drives all sampling through ``rand_chacha::ChaChaRng`` (ChaCha20,
rand_chacha 0.2.2 / rand 0.7, pinned in Cargo.toml) seeded as
``ChaChaRng::from_seed([189u8; 32])`` in every test (e.g. gossip.rs:1046).
Reproducing that stream exactly lets us port the reference's golden tests
(exact stakes, exact active-set membership) instead of only statistical checks.

Implements:
  * ChaCha20 block function + the rand_core 0.5 ``BlockRng`` buffering
    discipline (4 blocks / 64 u32 words per refill, u64 = lo-word | hi-word<<32,
    including the buffer-straddling path).
  * rand 0.7 ``gen_range(low, high)`` for u64 (widening-multiply rejection
    sampling, uniform.rs ``sample_single``).

This is a clean-room reimplementation from the published algorithm
specifications (ChaCha20 RFC 8439 core; rand crate documented behavior).
"""

from __future__ import annotations

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF

_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _quarter(x, a, b, c, d):
    x[a] = (x[a] + x[b]) & MASK32
    x[d] ^= x[a]
    x[d] = ((x[d] << 16) | (x[d] >> 16)) & MASK32
    x[c] = (x[c] + x[d]) & MASK32
    x[b] ^= x[c]
    x[b] = ((x[b] << 12) | (x[b] >> 20)) & MASK32
    x[a] = (x[a] + x[b]) & MASK32
    x[d] ^= x[a]
    x[d] = ((x[d] << 8) | (x[d] >> 24)) & MASK32
    x[c] = (x[c] + x[d]) & MASK32
    x[b] ^= x[c]
    x[b] = ((x[b] << 7) | (x[b] >> 25)) & MASK32


def _chacha20_block(key_words, counter, nonce_words):
    init = list(_CONSTANTS) + list(key_words) + [
        counter & MASK32,
        (counter >> 32) & MASK32,
        nonce_words[0],
        nonce_words[1],
    ]
    x = list(init)
    for _ in range(10):  # 10 double rounds = 20 rounds
        _quarter(x, 0, 4, 8, 12)
        _quarter(x, 1, 5, 9, 13)
        _quarter(x, 2, 6, 10, 14)
        _quarter(x, 3, 7, 11, 15)
        _quarter(x, 0, 5, 10, 15)
        _quarter(x, 1, 6, 11, 12)
        _quarter(x, 2, 7, 8, 13)
        _quarter(x, 3, 4, 9, 14)
    return [(a + b) & MASK32 for a, b in zip(x, init)]


class ChaChaRng:
    """rand_chacha 0.2.2-compatible ChaCha20 RNG (64-bit counter, stream 0)."""

    BUF_WORDS = 64  # 4 blocks per refill

    def __init__(self, seed: bytes, stream: int = 0):
        assert len(seed) == 32
        self.key = [int.from_bytes(seed[i * 4:(i + 1) * 4], "little") for i in range(8)]
        self.nonce = [stream & MASK32, (stream >> 32) & MASK32]
        self.counter = 0
        self.buf: list = []
        self.index = self.BUF_WORDS  # force refill on first use

    @classmethod
    def from_seed_byte(cls, byte: int) -> "ChaChaRng":
        """ChaChaRng::from_seed([byte; 32]) — the reference test seeding idiom."""
        return cls(bytes([byte]) * 32)

    def _generate(self):
        buf = []
        for i in range(4):
            buf.extend(_chacha20_block(self.key, self.counter + i, self.nonce))
        self.counter += 4
        self.buf = buf

    def next_u32(self) -> int:
        if self.index >= self.BUF_WORDS:
            self._generate()
            self.index = 0
        v = self.buf[self.index]
        self.index += 1
        return v

    def next_u64(self) -> int:
        # rand_core 0.5 BlockRng::next_u64 semantics, incl. straddling.
        idx = self.index
        if idx < self.BUF_WORDS - 1:
            self.index += 2
            return self.buf[idx] | (self.buf[idx + 1] << 32)
        if idx >= self.BUF_WORDS:
            self._generate()
            self.index = 2
            return self.buf[0] | (self.buf[1] << 32)
        # exactly one word left
        x = self.buf[self.BUF_WORDS - 1]
        self._generate()
        self.index = 1
        return (self.buf[0] << 32) | x

    # ---- rand 0.7 distributions ----

    def gen_range_u64(self, low: int, high: int) -> int:
        """rand 0.7 UniformInt::<u64>::sample_single(low, high) — half-open."""
        rng_span = (high - low) & MASK64
        lz = 64 - rng_span.bit_length()
        zone = ((rng_span << lz) & MASK64) - 1 & MASK64
        while True:
            v = self.next_u64()
            prod = v * rng_span
            hi, lo = prod >> 64, prod & MASK64
            if lo <= zone:
                return (low + hi) & MASK64
