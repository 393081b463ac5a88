"""The calibration grid's MAPE of ``candidates`` candidates a lane over
``lanes`` histories of ``bins`` bins x ``hosts`` hosts, whose candidates hold
``distinct_r`` distinct exponents (``calib_mape_grid``).

The fewest operations these inputs need: the candidates' host sums are
``H p_idle + (p_max - p_idle) (S2_t - Sr_t(r))``, so each (lane, bin, host)
takes a log and an addition to ``S2`` (2), each (lane, distinct r, bin,
host) an exponential and an addition to ``Sr`` (2), and each (lane,
candidate, bin) a fused multiply-add for the total, a subtraction, an
absolute value, a multiplication by the reciprocal of the measured power
and an addition to the sum (6).  Bytes: the utilization and the measured
power (float32), the candidates' three parameters and the MAPE written
(float32 a candidate).
"""


def ops(*, lanes: int, candidates: int, distinct_r: int, bins: int, hosts: int) -> int:
    return (2 * lanes * bins * hosts + 2 * lanes * distinct_r * bins * hosts
            + 6 * lanes * candidates * bins)


def nbytes(*, lanes: int, candidates: int, distinct_r: int, bins: int, hosts: int) -> int:
    return 4 * (lanes * bins * hosts + lanes * bins + 3 * lanes * candidates
                + lanes * candidates)
