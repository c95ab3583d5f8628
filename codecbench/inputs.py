"""The program's inputs, made with the plain reference."""

from __future__ import annotations

import torch

from codecbench import reference


def huff_file(data: torch.Tensor):
    """The port's HuffFile of a uint8 tensor as the plain reference encodes
    it, and the code's statistics (``reference.code_stats``)."""
    from huffmandecoderongpus_tpu_torch import HuffFile

    tree, bits, payload = reference.encode(data)
    hist = torch.bincount(data, minlength=256).cpu().numpy()
    hf = HuffFile(tree=tree, bits=bits, uncompressed_size=int(data.numel()),
                  payload=payload.cpu().numpy())
    return hf, reference.code_stats(tree, hist)
