from .result import Result, ResultSet, ResultFilter
from . import pairs
from .insert import InsHist, InsSample
