"""The built-in analysis passes, each the twin of a reference pass."""
from repro_torch.analysis.passes.astlint import AstLintPass
from repro_torch.analysis.passes.hostreads import HostReadsPass
from repro_torch.analysis.passes.kernel import KernelContractPass
from repro_torch.analysis.passes.transfer import HostTransferPass
from repro_torch.analysis.passes.variants import VariantsPass

__all__ = ["HostReadsPass", "HostTransferPass", "VariantsPass",
           "KernelContractPass", "AstLintPass", "default_passes"]


def default_passes():
    """The standard pass list the CLI runs, in the reference's order."""
    return [HostReadsPass(), HostTransferPass(), VariantsPass(),
            KernelContractPass(), AstLintPass()]
