"""The process's place in a distributed run: port of
``paddle_tpu/distributed/env.py`` (``get_rank`` :43, ``get_world_size``
:52).

With a ``torch.distributed`` process group initialized, the rank and
world size are the group's; otherwise they are the launcher's
environment, ``PADDLE_TRAINER_ID`` and ``PADDLE_TRAINERS_NUM`` (0 and 1
when unset), as the reference's fallback reads them.
"""

from __future__ import annotations

import os

import torch.distributed as dist


def _group_live() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank(group=None) -> int:
    if group is not None:
        return group.rank
    if _group_live():
        return dist.get_rank()
    return int(os.environ.get("PADDLE_TRAINER_ID", 0))


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    if _group_live():
        return dist.get_world_size()
    return int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
