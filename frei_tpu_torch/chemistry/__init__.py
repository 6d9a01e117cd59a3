from .api import chemistry
from .fastchem import (UNKNOWN_SPECIES, ChemTable, FastChemTorch,
                       equilibrium_log_pressures, hot_loop_mmr_fn,
                       load_chem_table)
from .mocks import MOCK_VMR, MockChemistry
from .names import (ATOMIC_MASS, iso_to_mass_amu, iso_to_mass_g,
                    iso_to_species, species_name_to_common_isotopologue_name,
                    species_name_to_fastchem_name)
