"""Seeded random initialisation on an explicit device.

Every `init_params` of the port takes a seed (or a generator) and a device
that defaults to "cuda": the parameters are drawn on that device by a
generator that lives there, and nothing lands on the CPU unless the caller
passes device="cpu". Without a CUDA device the default raises. On
device="meta" a tree of shapes and dtypes is built and nothing is drawn.
"""

from typing import Tuple, Union

import torch

Seed = Union[int, torch.Generator]


def make_generator(seed: Seed, device) -> Tuple[torch.Generator,
                                                torch.device]:
    """(generator, device to allocate on). An int seeds a new generator on
    `device`; a generator is used as it is and must live on a device of the
    same type. On "meta" a seed gives no generator (None): nothing is
    drawn."""
    device = torch.device(device)
    if device.type == "meta" and not isinstance(seed, torch.Generator):
        return None, device
    if isinstance(seed, torch.Generator):
        if seed.device.type != device.type:
            raise ValueError(f"generator on {seed.device} but device="
                             f"{device}: pass a generator made on {device}")
        return seed, seed.device
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen, gen.device
