"""Tools run by hand on the card while a cell is defined (not by the benchmark's runs)."""
