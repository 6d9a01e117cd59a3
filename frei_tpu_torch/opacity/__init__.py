from .etl import (OpacityStore, binned_opacity_stack, binned_opacity_tables,
                  download_atom, download_molecule, load_store,
                  make_synthetic_store, netcdf_to_store,
                  opacity_dir_to_store, resolve_rebin_engine)
from .hotpath import build_kappa_model
from .rayleigh import rayleigh_h2, rayleigh_he, rayleigh_total
from .tables import (LayerKappaTables, OpacityStack, interp_tp,
                     kappa_from_layer_tables, kappa_from_stack,
                     layer_interp_weights, load_example_opacity,
                     make_layer_tables, make_opacity_stack,
                     set_interp_mode)
