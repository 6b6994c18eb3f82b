"""The modes a cell runs in: one module each, found by the cell's "mode"."""
