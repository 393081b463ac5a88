"""The DES placement of ``lanes`` lanes of ``jobs`` jobs over ``bins`` bins
and ``hosts`` hosts (``des_place``).

Operations: each bin returns the cores of the jobs that end in it to every
host (``lanes x bins x hosts``), and each placement scans every host once
(``lanes x jobs x hosts``).  Bytes: the job fields (submit, duration and
cores as int32, valid as one byte), the host rows (mask and kill one byte,
outage start and end int32), three int32 a lane (cores a host, policy,
depth), and the schedule written (start and host int32 a job, attempts
int32 a lane).
"""


def ops(*, lanes: int, bins: int, hosts: int, jobs: int) -> int:
    return lanes * bins * hosts + lanes * jobs * hosts


def nbytes(*, lanes: int, bins: int, hosts: int, jobs: int) -> int:
    read = lanes * jobs * 13 + lanes * hosts * 10 + lanes * 12
    written = lanes * jobs * 8 + lanes * 4
    return read + written
