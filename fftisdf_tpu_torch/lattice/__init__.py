"""Cells, k-points and structure constructors: the port's copy of the JAX
package's host-side lattice layer (numpy only)."""
