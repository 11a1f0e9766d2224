"""Launch drivers of the port: so far the serving loop."""
