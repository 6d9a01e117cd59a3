from .fastchem import hot_loop_mmr_fn
from .mocks import MOCK_VMR, MockChemistry
from .names import (ATOMIC_MASS, iso_to_mass_amu, iso_to_mass_g,
                    iso_to_species, species_name_to_common_isotopologue_name,
                    species_name_to_fastchem_name)
