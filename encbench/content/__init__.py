"""Content generators, one module a kind, found by the name a mix's
``content`` gives: ``<name>.make(mix, width, height, seed, bit_depth)``
returns the pool of (y, cb, cr) host planes."""
