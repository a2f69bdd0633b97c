"""Faults planted in the program's timed path, for the tests on the CPU
and for reading each fault's numbers on the card
(``perfbench/tests/calibrate.py --fault``). Each wraps the train step
(``fault(step, trainable) -> step``) or the eval call's outputs
(``fault(mask_cls, mask_pred) -> (mask_cls, mask_pred)``), or is a
``Planted`` fault, which patches a choice of the port where it is made
and leaves the step and the outputs to the driver as they are."""

import importlib

import torch


class Planted:
    """A fault planted beneath the program's own functions: ``install()``
    patches the port and returns the function that undoes it."""

    def __init__(self, install):
        self.install = install
        self.__doc__ = install.__doc__


def _shuffle_points():
    """An answer altered where it is produced: the criterion's sampled
    points of each mask handed to the next mask, as an off-by-one in the
    rows of the importance sampling."""
    sc = importlib.import_module("odise_torch.losses.set_criterion")
    saved = sc.get_uncertain_point_coords_with_randomness

    def broken(*args, **kwargs):
        return torch.roll(saved(*args, **kwargs), 1, dims=0)

    sc.get_uncertain_point_coords_with_randomness = broken

    def undo():
        sc.get_uncertain_point_coords_with_randomness = saved
    return undo


def swap_images(mask_cls, mask_pred):
    """Each image handed the next one's answers, as an off-by-one in the
    batch index."""
    return torch.roll(mask_cls, 1, dims=0), torch.roll(mask_pred, 1, dims=0)


def state_unchanged(step, trainable):
    """A step that returns its state unchanged: the update is undone."""
    def broken(batch, generator):
        before = {n: p.detach().clone() for n, p in trainable.items()}
        metrics = step(batch, generator)
        with torch.no_grad():
            for n, p in trainable.items():
                p.copy_(before[n])
        return metrics
    return broken


def half_batch(step, trainable):
    """Half of the batch left out: the step sees the first half only, the
    mean taken over it."""
    def broken(batch, generator):
        half = next(iter(batch.values())).shape[0] // 2
        return step({k: v[:half] for k, v in batch.items()}, generator)
    return broken


INFER = {"swap_images": swap_images}
TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_batch,
         "shuffled_points": Planted(_shuffle_points)}
