from .file import dir_size, to_bytes  # noqa: F401
