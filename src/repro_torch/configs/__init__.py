"""Model configurations (copies of ``repro.configs``) for the architectures
the port can run."""
