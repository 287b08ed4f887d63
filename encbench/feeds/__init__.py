"""Feeds, one module a loop, found by the name a mix's ``loop`` gives:
``<name>.window(enc, picture, seconds)`` drives the window."""
