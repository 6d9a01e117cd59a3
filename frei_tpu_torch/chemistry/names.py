"""Species-name algebra: isotopologue / species / Hill-notation forms.

Pure-Python (host side) equivalents of the reference converters
(`frei/chemistry.py:13-111`), used to key opacity
tables ("1H2-16O"), map to equilibrium-chemistry species names in Hill
notation ("H2O1"), and compute molecular masses.  The reference pulls
atomic masses from the ``periodictable`` package; this module embeds the
IUPAC standard atomic weights directly so the framework is
self-contained.
"""

from __future__ import annotations

import re

from .. import constants as const

__all__ = [
    "ATOMIC_MASS", "iso_to_species", "iso_to_mass_amu", "iso_to_mass_g",
    "species_name_to_fastchem_name",
    "species_name_to_common_isotopologue_name",
]

#: IUPAC standard atomic weights [amu] for every element appearing in
#: the shipped equilibrium-chemistry tables (Asplund 2009 solar set).
ATOMIC_MASS = {
    "H": 1.008, "He": 4.002602, "Li": 6.94, "Be": 9.0121831, "B": 10.81,
    "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998403163,
    "Ne": 20.1797, "Na": 22.98976928, "Mg": 24.305, "Al": 26.9815384,
    "Si": 28.085, "P": 30.973761998, "S": 32.06, "Cl": 35.45,
    "Ar": 39.95, "K": 39.0983, "Ca": 40.078, "Sc": 44.955908,
    "Ti": 47.867, "V": 50.9415, "Cr": 51.9961, "Mn": 54.938043,
    "Fe": 55.845, "Co": 58.933194, "Ni": 58.6934, "Cu": 63.546,
    "Zn": 65.38, "Ge": 72.630,
    # electron "element" used by charged species in the chem tables
    "e-": 5.48579909065e-4,
}


def iso_to_species(isotopologue: str) -> str:
    """"1H2-16O" -> "H2O"; "48Ti-16O" -> "TiO" (`chemistry.py:13-21`)."""
    species = ""
    for element in isotopologue.split("-"):
        for s in re.findall(r"\D+\d*", element):
            species += "".join(s)
    return species if len(species) > 0 else isotopologue


def iso_to_mass_amu(isotopologue: str) -> float:
    """Isotopologue mass in amu: "1H2-16O" -> 18 (`chemistry.py:24-37`).

    Isotope numbers encode the masses directly; a bare element name
    (e.g. "Na") falls back to its standard atomic weight.
    """
    mass = 0.0
    for element in isotopologue.split("-"):
        multiples = [x for x in re.split(r"\D", element) if len(x) > 0]
        if len(multiples) > 1:
            species_mass, multiplier = multiples
            mass += float(multiplier) * float(species_mass)
        elif len(multiples) == 1:
            mass += float(multiples[0])
    if mass == 0.0:
        mass = ATOMIC_MASS[isotopologue]
    return mass


def iso_to_mass_g(isotopologue: str) -> float:
    """Isotopologue mass in grams."""
    return iso_to_mass_amu(isotopologue) * const.u_amu


def _split_atoms_multipliers(k: str):
    atoms = [x for x in re.split(r"(?<=[a-z])|(?=[A-Z])|\d", k) if len(x) > 0]
    multipliers = [int(x) if len(x) > 0 else 1 for x in re.split(r"\D", k)]
    # Multiplier for each atom sits right after its name in the string;
    # index it by the cumulative length of the atom names seen so far
    # (`chemistry.py:50-54`).
    cumsum, skipped = 0, []
    for atom in atoms:
        cumsum += len(atom)
        skipped.append(multipliers[cumsum])
    return atoms, skipped


def species_name_to_fastchem_name(k: str, return_mass: bool = False):
    """"H2O" -> "H2O1" Hill-ish notation (`chemistry.py:40-76`).

    Atoms are alphabetized with explicit multiplicities; a single-atom
    species keeps just the element name.
    """
    atoms, mults = _split_atoms_multipliers(k)
    order = sorted(range(len(atoms)), key=lambda i: atoms[i])
    notation = "".join(atoms[i] + str(mults[i]) for i in order)
    if len(notation) in (2, 3) and notation.endswith("1"):
        notation = notation[:-1]
    if return_mass:
        mass = sum(ATOMIC_MASS[a] * m for a, m in zip(atoms, mults))
        return notation, mass
    return notation


def species_name_to_common_isotopologue_name(k: str) -> str:
    """"H2O" -> "1H2-16O" (`chemistry.py:79-111`).

    Uses the rounded standard atomic weight as the isotope label for
    each atom, which matches the most-common-isotopologue convention of
    the DACE opacity filenames for the species exercised by the
    reference tests (`frei/tests/test_chemistry.py:91-100`).
    """
    atoms, mults = _split_atoms_multipliers(k)
    masses = [round(ATOMIC_MASS[a]) for a in atoms]
    if len(atoms) > 1:
        return "-".join(
            f"{mass}{a}" + (str(m) if m > 1 else "")
            for a, m, mass in zip(atoms, mults, masses)
        )
    return atoms[0]
