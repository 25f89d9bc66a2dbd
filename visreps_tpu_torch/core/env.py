"""Environment variable / .env handling and pickle IO (copy of
``visreps_tpu/core/env.py``)."""
from __future__ import annotations

import os
import pickle
from pathlib import Path

_DOTENV_LOADED = False


def load_dotenv(path: str | Path = ".env") -> None:
    """Load KEY=VALUE lines from a .env file into os.environ (no overwrite)."""
    global _DOTENV_LOADED
    p = Path(path)
    if p.exists():
        for line in p.read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, val = line.split("=", 1)
            os.environ.setdefault(key.strip(), val.strip().strip("\"'"))
    _DOTENV_LOADED = True


def get_env_var(key: str) -> str:
    """Path from env var, loading .env on first miss. Returns '' if unset."""
    if key not in os.environ and not _DOTENV_LOADED:
        load_dotenv()
    return os.environ.get(key, "")


def load_pickle(file_path: str | Path):
    """Unpickle a dataset file this project's preprocessing wrote."""
    try:
        with open(file_path, "rb") as f:
            return pickle.load(f)
    except FileNotFoundError:
        raise FileNotFoundError(f"Pickle file not found at path: {file_path}")
