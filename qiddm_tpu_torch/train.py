"""Training loops shared by the experiment drivers (counterpart of
``qiddm_tpu/train.py``).

Adam is ``torch.optim.Adam(lr)`` with its defaults, which are optax's
(b1 0.9, b2 0.999, eps 1e-8 added outside the square root). An optimizer
state is Adam's ``state_dict()``; segmented callers pass it back in so the
moments persist. A ``key`` is an int seed: every random draw of a run comes
from a CPU ``torch.Generator`` seeded from it.
"""

from __future__ import annotations

import copy
import time
from typing import List

import numpy as np
import torch


def _flat_on_device(diff, x_train) -> torch.Tensor:
    x = torch.as_tensor(np.asarray(x_train), dtype=torch.float32)
    return x.reshape(len(x), -1).to(diff.net.device)


def _adam(diff, lr: float, opt_state):
    optimizer = torch.optim.Adam(diff.parameters(), lr=lr)
    if opt_state is not None:
        optimizer.load_state_dict(opt_state)
    return optimizer


def train_diffusion(diff, x_train, *, epochs: int, batch_size: int, lr: float,
                    T: int, key=None, start_epoch: int = 0,
                    verbose: bool = False, opt_state=None) -> List[float]:
    """Train ``diff`` (a Diffusion) in place, one epoch at a time; returns
    the per-epoch loss values (each the SUM over batches of the batch's
    mean loss, src/mnist_exm.py:176-185). Epoch e draws from a generator
    seeded with ``(key, e)``, so a resumed run draws fresh shuffles and
    noise instead of replaying epochs 0..remaining."""
    key = 0 if key is None else int(key)
    x = _flat_on_device(diff, x_train)
    n_train = len(x)
    batch_size = min(batch_size, n_train)
    optimizer = _adam(diff, lr, opt_state)
    epoch_fn = diff.make_epoch_fn(optimizer, T, batch_size)

    loss_values: List[float] = []
    t0 = time.time()
    for e in range(start_epoch, epochs):
        seed = int(np.random.SeedSequence([key, e]).generate_state(1)[0])
        losses = epoch_fn(torch.Generator().manual_seed(seed), x, n_train)
        loss_values.append(float(losses.sum()))
        if verbose:
            print(f"epoch {e + 1}/{epochs} loss={loss_values[-1]:.6f} "
                  f"({time.time() - t0:.1f}s)")
    return loss_values


def train_diffusion_scan(diff, x_train, *, epochs: int, batch_size: int,
                         lr: float, T: int, key=None, mesh=None,
                         warmup: bool = True, opt_state=None,
                         return_opt_state: bool = False):
    """All epochs as one run of ``make_multi_epoch_fn``; returns
    ``(epoch_losses, wall[, opt_state])``.

    ``warmup=True`` (benchmark mode) runs once untimed, then restores the
    starting parameters and optimizer state and times a second identical
    run: the wall excludes first-use set-up (kernel build, allocator
    warm-up) but the device trains twice. Drivers pass ``warmup=False``:
    one run, timed. The wall ends when the device has finished.

    With ``mesh`` (every rank calling with the same arguments), the
    tau-expanded batch of every step splits over its ``data`` dim and the
    gradients are summed over it (``Diffusion.make_multi_epoch_fn``).
    """
    key = 0 if key is None else int(key)
    x = _flat_on_device(diff, x_train)
    n_train = len(x)
    batch_size = min(batch_size, n_train)

    if warmup:
        start = (copy.deepcopy(diff.net.state_dict()),
                 copy.deepcopy(opt_state))
        optimizer = _adam(diff, lr, opt_state)
        diff.make_multi_epoch_fn(optimizer, T, batch_size, epochs,
                                 mesh=mesh)(
            torch.Generator().manual_seed(key), x, n_train).cpu()
        diff.net.load_state_dict(start[0])
        opt_state = start[1]
    optimizer = _adam(diff, lr, opt_state)
    run = diff.make_multi_epoch_fn(optimizer, T, batch_size, epochs,
                                   mesh=mesh)
    t0 = time.time()
    epoch_losses = run(torch.Generator().manual_seed(key), x, n_train)
    epoch_losses = epoch_losses.cpu().numpy()  # waits for the device
    wall = time.time() - t0
    if return_opt_state:
        return epoch_losses, wall, optimizer.state_dict()
    return epoch_losses, wall
