"""Seeded FM broadcast traffic: periodic u8 I/Q captures and the step pool.

A capture is what one RTL-SDR dongle delivers from one station: the FM
stereo multiplex (L+R, 19 kHz pilot, L-R on 38 kHz, RDS on 57 kHz;
ITU-R BS.450, EN 50067) frequency-modulated at 75 kHz deviation and
quantised to offset-binary u8 I/Q with dither.  Each distinct capture has
its own left and right tones, its own pilot phase and its own RDS PI and
PS name.

Every capture is exactly periodic over the pool's period: each tone, the
pilot and the RDS symbol clock complete whole cycles in it, the RDS
waveform is built as a periodic spectrum, and the multiplex has zero mean,
so the FM phase returns to its start.  A station's stream can then wrap at
the end of the pool with no discontinuity, and a run may last any number of
periods.  (A wrapping stream with a jump would make the RDS carrier's
phase tracker choose a branch at every wrap, where rounding alone can tip
it; the comparison with the reference would then fail by chance.)

The pool holds `steps` whole steps, each (stations, step_bytes) u8 and
contiguous, so feeding a step copies nothing on the host.  Station s plays
capture c_s from its own offset o_s, so no two rows are alike.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses

import numpy as np

RF_FS = 2_400_000          # u8 I/Q pairs per second (RTL-SDR, every cell)
PILOT_HZ = 19_000
SYMBOL_RATE = 2375         # RDS symbols per second (1187.5 bit/s biphase)
RRC_BETA = 0.9
KF = 75_000.0              # peak deviation
# multiplex amplitudes (the program's own test captures use the same mix)
A_MONO, A_PILOT, A_STEREO, A_RDS = 0.45, 0.1, 0.45, 0.1

_GEN = 0b10110111001       # g(x) = x^10 + x^8 + x^7 + x^5 + x^4 + x^3 + 1
_OFFSET = {"A": 0x0FC, "B": 0x198, "C": 0x168, "D": 0x1B4}


@dataclasses.dataclass(frozen=True)
class CaptureMeta:
    left_hz: float
    right_hz: float
    pi: int
    ps: str


def _block_bits(info: int, offset: str) -> list[int]:
    """One 26-bit RDS block: 16 info bits and the offset checkword."""
    reg = info << 10
    for i in range(25, 9, -1):
        if (reg >> i) & 1:
            reg ^= _GEN << (i - 10)
    word = (info << 10) | ((reg & 0x3FF) ^ _OFFSET[offset])
    return [(word >> (25 - i)) & 1 for i in range(26)]


def group_bits(pi: int, ps: str, radio_text: str, n_bits: int) -> np.ndarray:
    """The first n_bits of an alternating 0A (PS) / 2A (RT) group stream."""
    ps = (ps + " " * 8)[:8]
    rt = (radio_text + " " * 64)[:64]
    pty = 5
    bits: list[int] = []
    g = 0
    while len(bits) < n_bits:
        if g % 2 == 0:
            seg = (g // 2) % 4
            b2 = (pty << 5) | (1 << 3) | seg
            b3 = 0xE0E0
            b4 = (ord(ps[2 * seg]) << 8) | ord(ps[2 * seg + 1])
        else:
            seg = (g // 2) % 16
            b2 = (2 << 12) | (pty << 5) | seg
            c = rt[4 * seg: 4 * seg + 4]
            b3 = (ord(c[0]) << 8) | ord(c[1])
            b4 = (ord(c[2]) << 8) | ord(c[3])
        for info, off in ((pi, "A"), (b2, "B"), (b3, "C"), (b4, "D")):
            bits += _block_bits(info, off)
        g += 1
    return np.asarray(bits[:n_bits], np.uint8)


def rds_waveform(bits: np.ndarray, n: int) -> np.ndarray:
    """Periodic RRC-shaped biphase baseband of `bits`, n samples at RF_FS
    (float32, peak 1).  Differential then biphase coding gives 2 symbols per
    bit; the symbols are spaced n/K samples apart (K symbols per period),
    so their periodic spectrum is the K-point DFT repeated, shaped by the
    root-raised-cosine response."""
    diff = np.bitwise_xor.accumulate(bits.astype(np.uint8))
    sym = np.empty(2 * len(diff))
    sym[0::2] = np.where(diff == 1, 1.0, -1.0)
    sym[1::2] = -sym[0::2]
    k = len(sym)
    period_s = n / RF_FS
    f = np.arange(n // 2 + 1) / period_s
    lo = (1 - RRC_BETA) * SYMBOL_RATE / 2
    hi = (1 + RRC_BETA) * SYMBOL_RATE / 2
    resp = np.where(f <= lo, 1.0, 0.0)
    band = (f > lo) & (f <= hi)
    resp[band] = np.sqrt(0.5 * (1 + np.cos(np.pi / (RRC_BETA * SYMBOL_RATE)
                                             * (f[band] - lo))))
    nz = int(np.count_nonzero(resp))
    spec = np.zeros(n // 2 + 1, np.complex128)
    spec[:nz] = np.fft.fft(sym)[np.arange(nz) % k] * resp[:nz]
    out = np.fft.irfft(spec, n)
    return (out / np.abs(out).max()).astype(np.float32)


def _cycles_phase(freq_hz: float, n: int) -> np.ndarray:
    """2*pi*f*t at t = i/RF_FS, reduced modulo 2*pi in integers: f is
    rounded to a whole number of cycles per period of n samples."""
    num = int(round(freq_hz * n / RF_FS))          # cycles per period
    i = np.arange(n, dtype=np.int64)
    return (2 * np.pi / n) * ((i * num) % n).astype(np.float64)


def synthesize(n: int, seed: int, index: int) -> tuple[np.ndarray, CaptureMeta]:
    """One periodic capture of n I/Q pairs: interleaved u8 (2n,)."""
    rng = np.random.default_rng([seed, index])
    period_s = n / RF_FS
    # whole cycles in the period: tones on the period's frequency grid
    f_l = round((800.0 + 100.0 * index + rng.uniform(0, 50)) * period_s) / period_s
    f_r = round((2000.0 + 150.0 * index + rng.uniform(0, 50)) * period_s) / period_s
    pilot0 = rng.uniform(0, 2 * np.pi)
    pi_code = 0x3D40 + (index & 0xFF)
    ps = f"BENCH{index:03d}"[:8]
    bits = group_bits(pi_code, ps, f"STATION {index} SEED {seed}",
                      int(round(period_s * SYMBOL_RATE / 2)))
    left = np.sin(_cycles_phase(f_l, n))
    right = np.sin(_cycles_phase(f_r, n))
    theta = _cycles_phase(PILOT_HZ, n) + pilot0
    m = (A_MONO * (left + right) / 2 + A_PILOT * np.cos(theta)
         + A_STEREO * (left - right) / 2 * np.cos(2 * theta)
         + A_RDS * rds_waveform(bits, n) * np.cos(3 * theta))
    m -= m.mean()                     # the FM phase returns to its start
    phase = np.cumsum(m) * (2 * np.pi * KF / RF_FS) + rng.uniform(0, 2 * np.pi)
    phase = np.mod(phase, 2 * np.pi)
    iq = np.empty(2 * n, np.float64)
    iq[0::2] = np.cos(phase)
    iq[1::2] = np.sin(phase)
    iq = iq * (0.9 * 128.0) + 128.0 + rng.uniform(-0.5, 0.5, 2 * n)
    u8 = np.clip(np.round(iq), 0, 255).astype(np.uint8)
    return u8, CaptureMeta(f_l, f_r, pi_code, ps)


@dataclasses.dataclass
class Pool:
    """(steps, stations, step_bytes) u8 plus how each row was made."""
    data: np.ndarray
    capture_of: np.ndarray          # (stations,) distinct capture index
    offset_of: np.ndarray           # (stations,) start offset in I/Q pairs
    meta: list[CaptureMeta]

    def block(self, k: int) -> np.ndarray:
        """Step k of every station's stream (contiguous, no host copy)."""
        return self.data[k % self.data.shape[0]]

    def station_block(self, station: int, k: int) -> np.ndarray:
        return self.data[k % self.data.shape[0], station]


def build_pool(seed: int, stations: int, step_bytes: int, steps: int,
               distinct: int, workers: int = 8) -> Pool:
    """The seeded pool: `distinct` periodic captures of steps*step_bytes
    bytes, spread over `stations` rows with per-station offsets."""
    n = steps * step_bytes // 2
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        made = list(ex.map(lambda c: synthesize(n, seed, c), range(distinct)))
    caps = [u8 for u8, _ in made]
    rng = np.random.default_rng([seed, 1 << 20])
    capture_of = np.arange(stations) % distinct
    offset_of = rng.integers(0, n, size=stations)
    data = np.empty((steps, stations, step_bytes), np.uint8)
    for s in range(stations):
        cap = caps[capture_of[s]]
        o = 2 * int(offset_of[s])
        data[:, s, :] = np.concatenate([cap[o:], cap[:o]]).reshape(
            steps, step_bytes)
    return Pool(data, capture_of, offset_of, [m for _, m in made])
