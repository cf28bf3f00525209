"""Op lowerings (torch), one plain function per op; importing a module
registers its ops (framework/registry.py)."""
