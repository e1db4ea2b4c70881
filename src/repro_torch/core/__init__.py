"""Core algorithms of the port: tree, lookup, routing, index build, search."""
