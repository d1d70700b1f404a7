from .report import Report, ReportWriter, REPMATEFLG, REPPAIR
