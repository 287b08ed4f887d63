"""Tile meshes: CTU-row bands of a frame over several devices (the JAX
package's x265_tpu/parallel/). mesh.py builds them; tiles.py holds the
band step (halo exchange, band-local analysis, the psum'd frame cost)
and the mesh's intra decisions that the encoder runs under attach_mesh.
"""
