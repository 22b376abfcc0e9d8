"""The port's runtime layer (so far: the pack cache).  Submodules are
imported by name; this file loads nothing."""
