"""Public surface of the port: types, index construction, the engine.

Names resolve on first access (PEP 562), so importing a submodule such as
`repro_torch.core.isax` does not import the engine — the kernels' plain
versions import core modules, and the engine imports the kernels.
"""
import importlib

_EXPORTS = {"Collection": "types", "EnvelopeParams": "types",
            "EnvelopeSet": "types", "QuerySpec": "engine",
            "UlisseEngine": "engine", "SearchResult": "executor",
            "SearchStats": "executor", "UlisseIndex": "index",
            "build_index": "index"}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
