"""Parallelism of the port: so far only the parameter-spec dataclass."""
