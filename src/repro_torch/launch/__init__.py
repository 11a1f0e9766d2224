"""Launch entry points of the port: the serving loop and the column mesh."""
