"""GFE-Mamba in PyTorch for NVIDIA Hopper (H100).

The port of ``gfe_mamba_tpu``: the same models and layouts (channels-last
volumes ``(B, X, Y, Z, C)``, ``(B, L, ED)`` sequences), with the JAX
package's Pallas TPU kernels replaced by CUDA C++ kernels written for
``sm_90a`` (``csrc/``).  Entry points run on the GPU unless the caller
passes ``device="cpu"``; on CPU tensors every kernel's plain PyTorch
version runs instead.

Each subpackage re-exports the names of its JAX twin's ``__init__.py``
lazily (:func:`lazy_exports`): a name's module is imported when the name
is first read, so importing a subpackage loads none of its modules, and
no import builds or loads a kernel.
"""

from __future__ import annotations

import importlib
import sys

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the GPU, and raises
    when there is none rather than falling back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def lazy_exports(package: str, exports: dict):
    """``(__getattr__, __dir__)`` for a package that re-exports
    ``exports``, a map from each name to the submodule that defines it (a
    name equal to its submodule's is the submodule itself)."""

    def __getattr__(name: str):
        if name not in exports:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        module = importlib.import_module(f"{package}.{exports[name]}")
        return module if exports[name] == name else getattr(module, name)

    def __dir__():
        return sorted(set(vars(sys.modules[package])) | set(exports))

    return __getattr__, __dir__


from gfe_mamba_torch import config  # noqa: E402,F401 (as the JAX package)
