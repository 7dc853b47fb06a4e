from .transformer import Model  # noqa: F401
