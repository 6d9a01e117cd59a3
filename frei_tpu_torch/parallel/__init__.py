from .solve import solve_population
