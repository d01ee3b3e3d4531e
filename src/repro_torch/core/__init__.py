"""Solver core: GLM families, CD sweeps, line search, superstep, session."""
