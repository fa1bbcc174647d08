"""Filesystem path helpers.

The port's copy of the JAX package's `utils/paths.py`
(`collect_paths_to_files_in_subdirectories` :12,
`collect_immediate_subdirectories` :22, `makedirs_if_needed` :30).
"""

from __future__ import annotations

import os
from typing import List


def collect_paths_to_files_in_subdirectories(path_to_directory: str,
                                             extension: str) -> List[str]:
    """Recursively collects sorted paths to files with the given
    extension."""
    paths = []
    for root, _dirs, files in os.walk(path_to_directory):
        for name in files:
            if name.endswith(extension):
                paths.append(os.path.join(root, name))
    return sorted(paths)


def collect_immediate_subdirectories(path_to_directory: str) -> List[str]:
    """Sorted names of the immediate subdirectories of a directory."""
    return sorted(
        d for d in os.listdir(path_to_directory)
        if os.path.isdir(os.path.join(path_to_directory, d)))


def makedirs_if_needed(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path
