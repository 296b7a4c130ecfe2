"""The drivers' waits on the card and its memory."""

import gc

import torch


def on_card(device):
    return torch.device(device).type == "cuda"


def sync(device):
    """Wait for the card's queued work (nothing on the CPU)."""
    if on_card(device):
        torch.cuda.synchronize(device)


def free(device):
    """Return what the freed program held to the card."""
    gc.collect()
    if on_card(device):
        torch.cuda.empty_cache()


def peak_bytes(device):
    """The card's peak of allocated memory so far (0 on the CPU)."""
    return torch.cuda.max_memory_allocated(device) if on_card(device) else 0
