"""Launch entry points of the port: the serving loop, the trainer and the
column mesh."""
