"""Version information (the JAX package's ``stonkgs_tpu/version.py``)."""

from __future__ import annotations

import os
from subprocess import CalledProcessError, check_output

__all__ = ["VERSION", "get_version", "get_git_hash"]

VERSION = "0.1.0-dev"


def get_git_hash() -> str:
    """The checkout's short commit hash, or 'UNHASHED' outside a git
    checkout."""
    with open(os.devnull, "w") as devnull:
        try:
            ret = check_output(
                ["git", "rev-parse", "--short", "HEAD"],
                cwd=os.path.dirname(__file__),
                stderr=devnull,
            )
        except (CalledProcessError, FileNotFoundError):
            return "UNHASHED"
        return ret.strip().decode("utf-8")


def get_version(with_git_hash: bool = False) -> str:
    """The package version, optionally suffixed with the git hash."""
    return f"{VERSION}-{get_git_hash()}" if with_git_hash else VERSION


if __name__ == "__main__":
    print(get_version(with_git_hash=True))
