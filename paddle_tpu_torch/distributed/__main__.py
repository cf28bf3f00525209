"""The rank processes' entry of `distributed.launch` (spawn.py)."""

from .spawn import main

main()
