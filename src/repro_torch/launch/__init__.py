"""Entry points of the port: the serving loop, and the cost constants."""
