"""The simulator core, ported module by module from ``repro.core``."""
