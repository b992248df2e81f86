"""State-embedding selection from scalar time + transition times
(counterpart of `hosnerf_tpu/models/state.py`)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

STATE_EPS = 1e-5


def state_index(time, transitions: Optional[torch.Tensor]) -> torch.Tensor:
    """time -> state index with the reference's epsilon ladder:
    state 0 for time < T0 - eps; state k >= 1 for the first k with
    time <= Tk + eps; state K otherwise."""
    time = torch.as_tensor(time)
    if transitions is None or transitions.shape[0] == 0:
        return torch.zeros(time.shape, dtype=torch.int32, device=time.device)
    transitions = transitions.to(time.device)
    first = (time >= transitions[0] - STATE_EPS).to(torch.int32)
    rest = torch.sum((time[..., None] > transitions[1:] + STATE_EPS)
                     .to(torch.int32), dim=-1)
    return (first + first * rest).to(torch.int32)


def state_indexer(transitions) -> Callable[..., torch.Tensor]:
    """index(time) -> state_index(time, transitions), for a function called
    once a step: the transition times (a sequence, an array, a tensor or
    None) become f32 once and are copied to a time's device at the first
    call with a time there, never again (a copy from the host at every
    call blocks the host until the card has drained its queue)."""
    trans = (torch.as_tensor(transitions, dtype=torch.float32)
             if transitions is not None and len(transitions) else None)
    placed = {}

    def index(time) -> torch.Tensor:
        time = torch.as_tensor(time)
        if trans is None:
            return state_index(time, None)
        if time.device not in placed:
            placed[time.device] = trans.to(time.device)
        return state_index(time, placed[time.device])

    return index


def state_rows(embeds: Sequence[torch.Tensor], state_idx) -> torch.Tensor:
    """The rows of the state embeddings `embeds` (K tensors [E]) at a 0-d
    index ([E]) or a per-ray one ([R, E]), gathered through a 1-D index:
    torch reads a 0-d index on the card back to the host, and the host
    waits for the card there."""
    table = torch.stack(list(embeds))
    idx = torch.as_tensor(state_idx, device=table.device)
    return table[idx.reshape(-1).long()].reshape(idx.shape + table.shape[1:])
