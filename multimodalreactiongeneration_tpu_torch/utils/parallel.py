"""Host-side parallel launcher (reference mr_gen/utils/parallel.py:174-197).

A copy of ``multimodalreactiongeneration_tpu/utils/parallel.py``. The
default is sequential; ``n_jobs > 1`` uses threads (the corpus workloads
are dominated by file IO, where threads overlap), or a process pool with
``use_processes=True``.
"""

from __future__ import annotations

from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Any, Callable, Iterable, List, Sequence


def parallel_launcher(
    func: Callable,
    arg_list: Sequence[Any],
    n_jobs: int = 1,
    unpack: bool = False,
    use_processes: bool = False,
) -> List[Any]:
    """Apply ``func`` over ``arg_list`` (tuples unpacked when ``unpack``)."""
    call = (lambda a: func(*a)) if unpack else func
    if n_jobs <= 1 or len(arg_list) <= 1:
        return [call(a) for a in arg_list]
    pool_cls = ProcessPoolExecutor if use_processes else ThreadPoolExecutor
    with pool_cls(max_workers=n_jobs) as pool:
        return list(pool.map(call, arg_list))
