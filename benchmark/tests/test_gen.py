import numpy as np

from benchmark.gen import captures


def test_pool_is_seeded_distinct_and_contiguous():
    a = captures.build_pool(2**31 + 99, 6, 76800, 4, 3)
    b = captures.build_pool(2**31 + 99, 6, 76800, 4, 3)
    c = captures.build_pool(2**31 + 100, 6, 76800, 4, 3)
    assert np.array_equal(a.data, b.data)
    assert not np.array_equal(a.data, c.data)
    assert a.block(5).flags["C_CONTIGUOUS"]
    assert np.shares_memory(a.block(5), a.data)
    rows = a.data.transpose(1, 0, 2).reshape(6, -1)
    assert len({r.tobytes() for r in rows}) == 6


def test_station_stream_is_the_capture_from_its_offset():
    pool = captures.build_pool(7, 4, 76800, 4, 2)
    n = 4 * 76800 // 2
    cap, _ = captures.synthesize(n, 7, pool.capture_of[3])
    o = 2 * int(pool.offset_of[3])
    stream = np.concatenate([pool.station_block(3, k) for k in range(4)])
    assert np.array_equal(stream, np.roll(cap, -o))


def _phase(u8):
    v = (u8.astype(np.float64) - 128.0) / 128.0
    return np.unwrap(np.angle(v[0::2] + 1j * v[1::2]))


def test_capture_wraps_without_a_jump():
    # the FM phase step across the wrap is like any other step
    n = 8 * 38400
    cap, meta = captures.synthesize(n, 3, 1)
    ph = _phase(np.concatenate([cap, cap[:2000]]))
    steps = np.diff(ph)
    across = steps[n - 1]
    assert abs(across) <= np.abs(steps[: n - 1]).max() + 0.05
    assert meta.left_hz * n / captures.RF_FS == round(meta.left_hz * n
                                                      / captures.RF_FS)


def test_rds_group_bits_carry_valid_checkwords():
    bits = captures.group_bits(0x3D41, "BENCH001", "RT", 104)
    blocks = bits.reshape(4, 26)
    info = int("".join(map(str, blocks[0, :16])), 2)
    assert info == 0x3D41
    # syndrome of block A with its offset removed is zero
    word = int("".join(map(str, blocks[0])), 2)
    reg = word ^ 0x0FC
    for i in range(25, 9, -1):
        if (reg >> i) & 1:
            reg ^= 0b10110111001 << (i - 10)
    assert reg & 0x3FF == 0
